"""The LM stack on a live (data 2, model 2) ``DeviceMesh`` of four
``gloo`` ranks (ROADMAP A.13b), one world for the module
(``_dist_cases.run_world``), and the twin of
``tests/test_elastic.py::test_restore_onto_different_mesh``.

Held as in ``test_torch_dist_lm.py`` (``_dist_lm``): a train step of
each family's smoke arch against the reference's one-device step,
``microbatches = 2`` with ZeRO-1's ``acc_shardings``, a fault on one
rank in ``run_training`` restored by every rank, prefill and decode
against one process.

The elastic twin: a checkpoint the reference's ``save_checkpoint``
wrote on one device (minitron-4b's smoke state at step 3) restored by
the port onto the (2, 2) mesh with ``shardings=``: every leaf with the
requested placements, holding exactly its shard, and the reference's
values bit for bit; saved again by the four ranks and restored at one
process, bit for bit.
"""

import json

import jax
import numpy as np

from repro.configs import get_smoke_config
from repro.train.checkpoint import save_checkpoint as ref_save
from repro.train.step import init_train_state as ref_init

import pytest

from _dist_cases import run_world
from _dist_lm import (
    ARCHS,
    check_loop,
    check_serve,
    check_step,
    lm_inputs,
    named,
)

BASE = dict(mesh=(2, 2), names=("data", "model"))
ELASTIC = "minitron-4b"


def _reference_checkpoint(path) -> dict:
    """The reference's step-3 checkpoint of ``ELASTIC``'s fresh smoke
    state, written on one device; returns its arrays by leaf name."""
    ref_save(str(path), 3, ref_init(get_smoke_config(ELASTIC),
                                    jax.random.PRNGKey(0)))
    ckpt = path / "ckpt_3"
    manifest = json.loads((ckpt / "manifest.json").read_text())
    with np.load(ckpt / "arrays.npz") as data:
        return {meta["name"]: data[key]
                for key, meta in manifest["leaves"].items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_lm4")
    saved = _reference_checkpoint(tmp / "elastic")
    spec = {f"step-{a}": dict(kind="lm_step", arch=a,
                              inputs=lm_inputs(tmp, a), **BASE)
            for a in ARCHS}
    spec["mb"] = dict(kind="lm_step", arch="mamba2-780m", microbatches=2,
                      inputs=lm_inputs(tmp, "mamba2-780m"), **BASE)
    spec["serve"] = dict(kind="lm_serve", arch="minicpm-2b", gen=4,
                         inputs=lm_inputs(tmp, "minicpm-2b"), **BASE)
    spec["loop"] = dict(kind="lm_loop", arch="granite-moe-3b-a800m",
                        dir=str(tmp / "loop"),
                        inputs=lm_inputs(tmp, "granite-moe-3b-a800m"),
                        **BASE)
    spec["elastic"] = dict(kind="lm_restore", arch=ELASTIC, step=3,
                           dir=str(tmp / "elastic"), **BASE)
    return run_world(4, spec, tmp), saved


@pytest.mark.parametrize("arch", ARCHS)
def test_step_matches_reference(world, arch):
    check_step(world[0][f"step-{arch}"], arch)


def test_microbatches_with_acc_shardings_match_reference(world):
    check_step(world[0]["mb"], "mamba2-780m", microbatches=2)


def test_prefill_and_decode_match_one_process(world):
    check_serve(world[0]["serve"])


def test_fault_on_one_rank_restores_every_rank(world):
    check_loop(world[0]["loop"], 4)


def test_reference_checkpoint_restores_onto_a_live_mesh(world):
    out, saved = world[0]["elastic"], world[1]
    assert int(out["step"]) == 3 and bool(out["shards"])
    for run in ("onto", "alone"):
        got = named(out, run)
        assert sorted(got) == sorted(saved)
        for name, want in saved.items():
            assert got[name].dtype == want.dtype, name
            np.testing.assert_array_equal(got[name], want,
                                          err_msg=f"{run} {name}")
    assert int(out["alone_step"]) == 4
