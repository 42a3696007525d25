"""Datasets, the ELL sparse layout and one-vs-rest labels on torch
(counterpart of ``repro.data``)."""

from repro_torch.data.labels import (
    MultitaskLabels,
    multitask_labels,
    ovr_decode,
    ovr_labels,
)
from repro_torch.data.sparse import (
    EllMatrix,
    PodShardedEll,
    dense_to_ell,
    ell_append,
    ell_from_rows,
    ell_matvec,
    ell_repack,
    ell_row_dot,
    ell_row_nnz,
    ell_row_partition,
    pod_row_layout,
)
from repro_torch.data.synthetic import (
    DATASET_RECIPES,
    SyntheticDataset,
    make_dataset,
)

__all__ = [
    "EllMatrix",
    "PodShardedEll",
    "dense_to_ell",
    "ell_append",
    "ell_from_rows",
    "ell_matvec",
    "ell_repack",
    "ell_row_nnz",
    "ell_row_dot",
    "ell_row_partition",
    "pod_row_layout",
    "MultitaskLabels",
    "multitask_labels",
    "ovr_labels",
    "ovr_decode",
    "SyntheticDataset",
    "make_dataset",
    "DATASET_RECIPES",
]
