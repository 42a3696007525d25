"""The LM trainer's checkpoints and fault-tolerant loop on the CPU: a
``TrainState`` crosses between the packages in both directions (the
hybrid's list indices, a master copy, a compression residual), and
``run_training`` recovers from an injected fault to the bits of a run
without one, aborts after ``max_retries``, counts stragglers, resumes
and collects old checkpoints."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.train.checkpoint import restore_checkpoint as ref_restore
from repro.train.checkpoint import save_checkpoint as ref_save
from repro.train.step import init_train_state as ref_init
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.convert import (
    params_from_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from repro_torch.data.lm_data import MarkovCorpus, make_lm_batch
from repro_torch.optim import make_schedule
from repro_torch.train import (
    LoopConfig,
    available_steps,
    latest_step,
    make_train_step,
    restore_checkpoint,
    run_training,
    save_checkpoint,
    train_state_for,
)
from repro_torch.tree import leaves, leaves_with_names, tree_map

from _lm_cases import LR, ref_params, train_batch

HYBRID = "jamba-1.5-large-398b"


def _trained_state(arch, steps=2, **kw):
    """A port state two steps in (moments, master, residual all nonzero)."""
    cfg = port_smoke_config(arch)
    state = train_state_for(params_from_numpy(cfg, ref_params(arch),
                                              device="cpu"), **kw)
    step = make_train_step(cfg, schedule=make_schedule("cosine", **LR),
                           compress_codec="int8" if kw.get("compress")
                           else None)
    b = {k: torch.from_numpy(v) for k, v in train_batch(
        get_smoke_config(arch)).items()}
    for _ in range(steps):
        state, _ = step(state, b)
    return state


def _ref_template(arch, **kw):
    return ref_init(get_smoke_config(arch), jax.random.PRNGKey(0), **kw)


def _assert_tree_bits(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape and x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("arch", [HYBRID, "minicpm-2b"])
def test_reference_restores_port_checkpoint(tmp_path, arch):
    state = _trained_state(arch, master=True, compress=True)
    save_checkpoint(str(tmp_path), 2, state)
    got, step = ref_restore(str(tmp_path), 2, _ref_template(
        arch, master=True, compress=True))
    assert step == 2
    _assert_tree_bits(jax.tree.map(np.asarray, got),
                      train_state_to_numpy(state))
    # the names are the reference's, list indices of the hybrid's
    # periods included
    names = [n for n, _ in leaves_with_names(train_state_to_numpy(state))]
    if arch == HYBRID:
        assert "params/periods/0/block/wq" in names or any(
            n.startswith("params/periods/0/block/") for n in names)
    assert {"opt/count", "step"} <= set(names)
    assert any(n.startswith("opt/master/") for n in names)
    assert any(n.startswith("compress/residual/") for n in names)


@pytest.mark.parametrize("arch", [HYBRID, "minicpm-2b"])
def test_port_restores_reference_checkpoint(tmp_path, arch):
    rng = np.random.default_rng(3)
    tmpl = _ref_template(arch, master=True, compress=True)
    ref_state = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape).astype(np.float32)
                   if a.dtype == jnp.float32 else np.asarray(a) + 5),
        tmpl)
    ref_save(str(tmp_path), 7, ref_state)
    port_tmpl = train_state_for(params_from_numpy(
        port_smoke_config(arch), ref_params(arch), device="cpu"),
        master=True, compress=True)
    got, step = restore_checkpoint(str(tmp_path), 7, port_tmpl)
    assert step == 7 and int(got.step) == 5 and int(got.opt.count) == 5
    _assert_tree_bits(train_state_to_numpy(got),
                      jax.tree.map(np.asarray, ref_state))
    # and from_numpy of the same state gives the same tensors
    direct = train_state_from_numpy(port_smoke_config(arch), ref_state,
                                    device="cpu")
    for a, b in zip(leaves(direct), leaves(got)):
        assert torch.equal(a, b)


def test_port_roundtrip_keeps_dtypes_and_bits(tmp_path):
    """bf16 moments are written widened to float32 and read back to the
    template's bf16 exactly."""
    cfg = port_smoke_config("minitron-4b")
    state = train_state_for(params_from_numpy(cfg, ref_params(
        "minitron-4b"), device="cpu"), m_dtype=torch.bfloat16)
    state = tree_map(lambda t: t + 1 if t.dtype == torch.int32 else
                     (t + 0.5).to(t.dtype), state)
    save_checkpoint(str(tmp_path), 3, state)
    back, _ = restore_checkpoint(str(tmp_path), 3, state)
    for a, b in zip(leaves(state), leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_restore_rejects_shape_mismatch_and_corruption(tmp_path):
    state = _trained_state("minitron-4b", steps=0)
    save_checkpoint(str(tmp_path), 1, state)
    other = train_state_for(params_from_numpy(
        port_smoke_config("minicpm-2b"), ref_params("minicpm-2b"),
        device="cpu"))
    with pytest.raises((ValueError, KeyError)):
        restore_checkpoint(str(tmp_path), 1, other)
    npz = tmp_path / "ckpt_1" / "arrays.npz"
    data = dict(np.load(npz))
    data["leaf_0"] = data["leaf_0"] + 1
    np.savez(npz, **data)
    with pytest.raises(ValueError, match="integrity"):
        restore_checkpoint(str(tmp_path), 1, state)


# ---------------------------------------------------------------- loop

ARCH = "minitron-4b"


def _loop_parts(steps=8):
    cfg = port_smoke_config(ARCH)
    corpus = MarkovCorpus(cfg.vocab_size, seed=0, device="cpu")
    step = make_train_step(cfg, schedule=make_schedule(
        "cosine", peak_lr=3e-3, total_steps=steps, warmup_steps=2),
        remat=False)

    def fresh():
        return train_state_for(params_from_numpy(cfg, ref_params(ARCH),
                                                 device="cpu"))
    return fresh, step, lambda t: make_lm_batch(corpus, t, 2, 16)


def test_fault_recovers_to_the_bits_of_a_clean_run(tmp_path):
    fresh, step, batch_fn = _loop_parts()
    clean, rep0 = run_training(fresh(), step, batch_fn, LoopConfig(
        total_steps=8, ckpt_dir=str(tmp_path / "a"), ckpt_every=2),
        log=lambda _: None)
    fired = []

    def hook(t):
        if t == 3 and not fired:
            fired.append(t)
            raise RuntimeError("injected")

    faulty, rep = run_training(fresh(), step, batch_fn, LoopConfig(
        total_steps=8, ckpt_dir=str(tmp_path / "b"), ckpt_every=2),
        fault_hook=hook, log=lambda _: None)
    assert rep.n_failures == 1 and rep.restarts == [("failure", 2)]
    assert rep.final_step == rep0.final_step == 8
    # steps 0–2, the fault at 3, steps 2–7 replayed from checkpoint 2
    assert len(rep.losses) == 9 and rep.losses[3] == rep0.losses[2]
    assert rep.losses[:3] + rep.losses[4:] == rep0.losses
    for a, b in zip(leaves(clean), leaves(faulty)):
        assert torch.equal(a, b)
    # the final checkpoint reads back the final state bit for bit
    back, s = restore_checkpoint(str(tmp_path / "b"), 8, faulty)
    assert s == 8
    for a, b in zip(leaves(faulty), leaves(back)):
        assert torch.equal(a, b)
    assert available_steps(str(tmp_path / "b")) == [4, 6, 8]


def test_max_retries_aborts(tmp_path):
    fresh, step, batch_fn = _loop_parts()

    def hook(t):
        if t == 1:
            raise RuntimeError("down for good")

    with pytest.raises(RuntimeError, match="aborting: 3 consecutive"):
        run_training(fresh(), step, batch_fn, LoopConfig(
            total_steps=4, ckpt_dir=str(tmp_path), ckpt_every=1,
            max_retries=2), fault_hook=hook, log=lambda _: None)


def test_stragglers_counted(tmp_path):
    """A deadline below any step's time counts every step; a deadline of
    0 counts none, as the reference's ``if cfg.step_deadline_s and ...``
    reads it (ROADMAP C.16)."""
    fresh, step, batch_fn = _loop_parts(4)
    seen = []
    _, rep = run_training(fresh(), step, batch_fn, LoopConfig(
        total_steps=4, ckpt_dir=str(tmp_path / "a"), step_deadline_s=1e-9),
        on_straggler=lambda t, dt: seen.append(t), log=lambda _: None)
    assert rep.n_stragglers == 4 and seen == [0, 1, 2, 3]
    _, rep = run_training(fresh(), step, batch_fn, LoopConfig(
        total_steps=4, ckpt_dir=str(tmp_path / "b"), step_deadline_s=0),
        log=lambda _: None)
    assert rep.n_stragglers == 0


def test_resume_from_newest_checkpoint(tmp_path):
    fresh, step, batch_fn = _loop_parts()
    cfg = LoopConfig(total_steps=4, ckpt_dir=str(tmp_path), ckpt_every=2)
    first, _ = run_training(fresh(), step, batch_fn, cfg, log=lambda _: None)
    assert latest_step(str(tmp_path)) == 4
    cfg.total_steps = 8
    resumed, rep = run_training(fresh(), step, batch_fn, cfg,
                                log=lambda _: None)
    assert rep.restarts[0] == ("resume", 4) and len(rep.losses) == 4
    whole, _ = run_training(fresh(), step, batch_fn, LoopConfig(
        total_steps=8, ckpt_dir=str(tmp_path / "whole"), ckpt_every=2),
        log=lambda _: None)
    for a, b in zip(leaves(resumed), leaves(whole)):
        assert torch.equal(a, b)
