"""The LM stack on a live multi-rank ``DeviceMesh`` (ROADMAP A.13b): two
``gloo`` ranks as (data 2, model 1) and as (data 1, model 2), each world
spawned once for the module (``_dist_cases.run_world``), on the smoke
config of one arch of each family — minicpm-2b (dense), mamba2-780m
(SSM), granite-moe-3b-a800m (MoE, experts over ``model``).

Every state leaf is a DTensor placed from the reference's parameters
(``convert.params_from_numpy(shardings=)``), with FSDP and ZeRO-1
moments.  Held (``_dist_lm``):

  * one train step against the reference's one-device step
    (``_lm_cases.ref_train_step``) at ``check_train_step``'s tolerances:
    the loss, the gathered gradients and the gathered updated
    parameters; each leaf written in place, in its own shard;
  * ``microbatches = 2`` with ZeRO-1's ``acc_shardings``, to the
    reference's microbatched step;
  * both gradient codecs on one arch: the one-process bits (top-k's
    threshold and int8's scale the one-device ones exactly);
  * ``run_training`` with a fault on one rank only: every rank restores
    the same checkpoint and ends on the bits of a run without the fault;
    its checkpoint, saved across the ranks, restores at one process and
    onto the mesh bit for bit (data world);
  * prefill and greedy decode against one process from the same
    parameters: tokens equal, logits at ``_lm_cases.RTOL``;
  * ``make_rank_mesh`` over the live group, and the arithmetic of the
    host staging of DTensor's collectives (``dist.collectives``);
  * the host-side collectives (a checkpoint's gather, the loop's
    failure flag, the codecs' gathers) on the device the backend takes
    (``collectives.crossing_device``), a save's gather on rank 0 alone.

The (data 2, model 2) world is ``test_torch_dist_lm4.py``.
"""

import numpy as np
import pytest

from _dist_cases import run_world
from _dist_lm import (
    ARCHS,
    check_codecs,
    check_loop,
    check_serve,
    check_step,
    lm_inputs,
)

MESHES = {"data": ((2, 1), ("data", "model")),
          "model": ((1, 2), ("data", "model"))}
# the one-arch items of each world: (microbatches, codecs, serving)
EXTRA = {"data": ("minicpm-2b", "mamba2-780m", ("granite-moe-3b-a800m",)),
         "model": ("granite-moe-3b-a800m", "minicpm-2b",
                   ("mamba2-780m", "minicpm-2b"))}


def _spec(tmp, world):
    shape, names = MESHES[world]
    mb, codec, serve = EXTRA[world]
    base = dict(mesh=shape, names=names)
    spec = {f"step-{a}": dict(kind="lm_step", arch=a,
                              inputs=lm_inputs(tmp, a), **base)
            for a in ARCHS}
    spec["mb"] = dict(kind="lm_step", arch=mb, microbatches=2,
                      inputs=lm_inputs(tmp, mb), **base)
    spec["codec"] = dict(kind="lm_codec", arch=codec,
                         inputs=lm_inputs(tmp, codec), **base)
    for a in serve:
        spec[f"serve-{a}"] = dict(kind="lm_serve", arch=a, gen=4,
                                  inputs=lm_inputs(tmp, a), **base)
    if world == "data":
        spec["loop"] = dict(kind="lm_loop", arch="minicpm-2b",
                            dir=str(tmp / "loop"),
                            inputs=lm_inputs(tmp, "minicpm-2b"), **base)
        spec["rank_mesh"] = dict(kind="rank_mesh")
        spec["staging"] = dict(kind="staging")
        spec["moe_groups"] = dict(kind="moe_groups")
        spec["host_side"] = dict(kind="host_side", dir=str(tmp / "host"))
    return spec


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """name → that world's arrays, each world spawned on first use."""
    done = {}

    def get(name):
        if name not in done:
            tmp = tmp_path_factory.mktemp(f"dist_lm_{name}")
            done[name] = run_world(2, _spec(tmp, name), tmp)
        return done[name]

    return get


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", list(MESHES))
def test_step_matches_reference(worlds, name, arch):
    check_step(worlds(name)[f"step-{arch}"], arch)


@pytest.mark.parametrize("name", list(MESHES))
def test_microbatches_with_acc_shardings_match_reference(worlds, name):
    check_step(worlds(name)["mb"], EXTRA[name][0], microbatches=2)


@pytest.mark.parametrize("name", list(MESHES))
def test_codecs_give_the_one_process_bits(worlds, name):
    check_codecs(worlds(name)["codec"])


@pytest.mark.parametrize("name", list(MESHES))
def test_prefill_and_decode_match_one_process(worlds, name):
    for a in EXTRA[name][2]:
        check_serve(worlds(name)[f"serve-{a}"])


def test_fault_on_one_rank_restores_every_rank(worlds):
    check_loop(worlds("data")["loop"], 2)


def test_moe_groups_over_data_give_the_one_process_gradients(worlds):
    """The scatter codec with token groups split over ``data`` (the
    smoke steps above have one group, which no mesh splits): the output
    and the gradients of x, the router and the experts within 1e-5 of
    one process (the router and experts, replicated over the split, sum
    their devices' parts: ``local_grad_placements``, ROADMAP C.21)."""
    out = worlds("data")["moe_groups"]
    for name in ("out", "d_x", "d_router", "d_wg", "d_wu", "d_wd"):
        np.testing.assert_allclose(out[f"mesh_{name}"], out[f"one_{name}"],
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_make_rank_mesh_spans_the_live_group(worlds):
    out = worlds("data")["rank_mesh"]
    assert str(out["device_type"]) == "cpu"
    assert out["shape"].tolist() == [2]
    assert "3 ranks" in str(out["raised"]) and "has 2" in str(
        out["raised"])


def test_make_rank_mesh_needs_a_group():
    import torch.distributed as dist

    from repro_torch.dist.mesh import make_rank_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="none"):
        make_rank_mesh((2,), ("data",), device="cpu")


def test_host_staging_computes_the_collectives(worlds):
    """The staged all-gather and reduce-scatter (along dims 0 and 1) and
    all-to-all give, bit for bit on every rank, the same function of
    every rank's input gathered (on the card the staging takes the place
    of torch's own for CUDA tensors, ``scripts/gloo_cuda_probe.py``);
    each call counted once."""
    out = worlds("data")["staging"]
    assert out["equal"].shape == (2, 5) and out["equal"].all()
    assert int(out["staged_calls"]) == 5


def test_host_side_collectives_cross_where_the_backend_takes_them(worlds):
    """Every tensor the host-side collectives hand to
    ``torch.distributed`` lies on ``crossing_device``'s device (the host
    under gloo); ``host_full`` gives every rank the leaf, or rank 0
    alone with ``dst=0`` (the others an empty tensor: a save builds one
    copy); the loop's failure flag raises on both ranks."""
    out = worlds("data")["host_side"]
    assert out["devices_ok"] and out["calls"].min() > 0
    assert out["every_equal"] and out["to0_equal"] and out["agreed"]
    assert out["to0_sizes"].tolist() == [[24, 24], [0, 0]]
    assert out["max"].tolist() == [1]
    assert out["gathered"].reshape(-1).tolist() == [0, 1]


@pytest.mark.parametrize("backend, want", [
    ("gloo", "cpu"), ("cpu:gloo,cuda:nccl", "cpu"), ("nccl", "cuda")])
def test_crossing_device_follows_the_backend(monkeypatch, backend, want):
    """A plain nccl group takes no CPU tensor: a host-side value crosses
    a ``cuda`` mesh on the card there, and on the host wherever gloo
    serves CPU tensors."""
    import types

    import torch.distributed as dist

    from repro_torch.dist import collectives

    monkeypatch.setattr(dist, "get_backend", lambda *a: backend)
    mesh = types.SimpleNamespace(device_type="cuda")
    assert collectives.crossing_device(mesh) == want
