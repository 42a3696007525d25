"""Device, mesh and launch-width policy of the port — the counterpart of
the part of ``repro/dist/mesh.py`` the ported slices use.

``resolve_device`` is where every entry point decides where it runs:
on the card unless the caller asks for the CPU, and never quietly on the
CPU when the card is missing.  ``SolverMesh`` names the solver's axes
and their sizes, without devices: on one card the reference's ``model``
axis becomes m virtual feature shards, a leading tensor dimension.
``pipeline_overlap`` is the reference's rule for the overlapped 2-D
round.  ``lane_pad`` and ``cta_threads`` size a kernel's thread block.
The reference's 128-lane padding of d and k is TPU tiling, not
semantics: the CUDA kernels take any width, so the port pads nothing but
the thread count, which rounds up to whole warps.  Nor does the
reference's VMEM admission (``dcd_feature_kernel_fits``) carry over: a
shape the kernels do not take makes their wrapper raise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

WARP = 32
MAX_CTA_THREADS = 256


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises when the card is asked for (or
    defaulted to) and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch runs on the GPU unless the "
            "caller passes device='cpu'")
    return dev


def lane_pad(d: int, lanes: int = WARP) -> int:
    """Round ``d`` up to a multiple of ``lanes`` (a warp by default)."""
    return ((d + lanes - 1) // lanes) * lanes


def cta_threads(width: int, most: int = MAX_CTA_THREADS) -> int:
    """Threads of a CTA that runs a DCD kernel over rows of ``width``
    entries: one thread per entry, in whole warps, at most ``most``
    (wider rows loop)."""
    return min(lane_pad(max(int(width), 1)), int(most))


class SolverMesh(NamedTuple):
    """A solver mesh as named axes and their sizes — the shape of the
    reference's ``jax.sharding.Mesh``, with no devices behind it."""

    axis_names: tuple
    axis_sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def solver_mesh_2d(data: int = 1, model: int = 1) -> SolverMesh:
    """The 2-D ``("data", "model")`` mesh of the feature-sharded solver:
    rows block-parallelize along ``data``, w and the features shard along
    ``model`` (m virtual shards on one card)."""
    if int(data) < 1 or int(model) < 1:
        raise ValueError(f"mesh sizes must be ≥ 1, got data={data}, "
                         f"model={model}")
    return SolverMesh(("data", "model"), (int(data), int(model)))


def pipeline_overlap(overlap, *, two_d: bool, fused: bool,
                     delay_rounds: int) -> bool:
    """Resolve the solver's ``overlap`` knob ∈ {False, True, "auto"} —
    whether the 2-D block round double-buffers its ``model``-axis
    (base, Gram) psum behind the next block's gram kernel (DESIGN.md
    §11).  When a round pipelines is *distribution* policy.

    The overlapped round needs (a) the fused 2-D engine, whose split
    gram/update phases expose an aggregate that can stay in flight — the
    unfused engine psums per update and the 1-D meshes have no
    ``model``-axis psum at all — and (b) ``delay_rounds ≥ 1``, the
    staleness bookkeeping (carried in-flight Δw) the overlapped schedule
    piggybacks on.  ``"auto"`` enables it exactly there; forcing ``True``
    elsewhere raises rather than silently changing semantics."""
    if overlap == "auto":
        return bool(two_d and fused and delay_rounds >= 1)
    overlap = bool(overlap)
    if not overlap:
        return False
    if not two_d:
        raise ValueError(
            "overlap=True needs a 2-D ('data', 'model') mesh — a 1-D "
            "mesh has no model-axis psum to double-buffer")
    if not fused:
        raise ValueError(
            "overlap=True needs the fused kernel path (use_kernel=True "
            "or an admitting 'auto') — only the split gram/update "
            "phases expose a (base, Gram) aggregate to keep in flight")
    if delay_rounds < 1:
        raise ValueError(
            "overlap=True needs delay_rounds >= 1 — the overlapped "
            "round carries its aggregates with the delayed-round "
            "bookkeeping")
    return True
