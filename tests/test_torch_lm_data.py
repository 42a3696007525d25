"""The LM trainer's small pieces against the reference on the CPU: the
new PRNG draws (``fold_in``, ``randint``, ``gumbel``, ``categorical``
and XLA's float32 log) bit for bit, the Markov corpus token for token,
the three LR schedules, AdamW and the two compression codecs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.lm_data import MarkovCorpus as RefCorpus
from repro.data.lm_data import make_lm_batch as ref_make_lm_batch
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.optim.adamw import adamw_update as ref_adamw_update
from repro.optim.grad_compress import compress_init as ref_compress_init
from repro.optim.grad_compress import compressed_grads as ref_compressed
from repro.optim.schedules import make_schedule as ref_schedule
from repro_torch import prng
from repro_torch.data.lm_data import MarkovCorpus, make_lm_batch
from repro_torch.optim import (
    adamw_init,
    adamw_update,
    compress_init,
    compressed_grads,
    make_schedule,
)


def _key(seed):
    k = jax.random.PRNGKey(seed)
    return k, torch.from_numpy(np.asarray(k).astype(np.int64))


def _bits(a):
    a = np.asarray(a, np.float32)
    return a.view(np.int32)


# ---------------------------------------------------------------- draws


@pytest.mark.parametrize("data", [0, 1, 7, 1000, 2**31 + 5, 2**32 - 1])
def test_fold_in_bit_equal(data):
    k, tk = _key(3)
    want = np.asarray(jax.random.fold_in(k, data)).astype(np.int64)
    np.testing.assert_array_equal(prng.fold_in(tk, data).numpy(), want)


# spans that are powers of two (the modulus exact) and are not, an
# empty range (the span taken as 1), a negative minval, a span whose
# 2¹⁶ mod span squared wraps in uint32
@pytest.mark.parametrize("lo,hi", [(0, 128), (0, 8192), (0, 97), (0, 50000),
                                   (-5, 100), (3, 3), (0, 131077),
                                   (0, 2**31 - 1)])
def test_randint_bit_equal(lo, hi):
    k, tk = _key(11)
    want = np.asarray(jax.random.randint(k, (3, 500), lo, hi))
    got = prng.randint(tk, (3, 500), lo, hi)
    np.testing.assert_array_equal(got.numpy(), want)
    # a stack of keys draws as vmap does; shape () a scalar a key
    ks = jax.random.split(k, 6)
    want = np.asarray(jax.vmap(lambda q: jax.random.randint(q, (), lo,
                                                            hi))(ks))
    got = prng.randint(torch.from_numpy(np.asarray(ks).astype(np.int64)),
                       (), lo, hi)
    np.testing.assert_array_equal(got.numpy(), want)


def test_xla_log_bit_equal():
    """Over the normal float32 range, near 1 and on the Gumbel draw's
    inner values: jnp.log's bits (torch.log's part in about 8 % of
    values)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.integers(0x00800000, 0x7F7FFFFF, 200_000).astype(
            np.int32).view(np.float32),
        (1 + rng.uniform(-1e-3, 1e-3, 50_000)).astype(np.float32),
        rng.uniform(1e-7, 90, 50_000).astype(np.float32)])
    want = np.asarray(jnp.log(x))
    got = prng.xla_log(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_gumbel_bit_equal():
    k, _ = _key(5)
    ks = jax.random.split(k, 4000)
    want = np.asarray(jax.vmap(lambda q: jax.random.gumbel(q, (8,)))(ks))
    got = prng.gumbel(torch.from_numpy(np.asarray(ks).astype(np.int64)),
                      (8,))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    want = np.asarray(jax.random.gumbel(k, (7, 33)))
    _, tk = _key(5)
    np.testing.assert_array_equal(_bits(prng.gumbel(tk, (7, 33))),
                                  _bits(want))


def test_categorical_bit_equal():
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((300, 8)) / 0.7).astype(np.float32)
    k, _ = _key(9)
    ks = jax.random.split(k, 300)
    want = np.asarray(jax.vmap(jax.random.categorical)(ks,
                                                       jnp.asarray(logits)))
    tks = torch.from_numpy(np.asarray(ks).astype(np.int64))
    got = [int(prng.categorical(tks[i], torch.from_numpy(logits[i])))
           for i in range(300)]
    np.testing.assert_array_equal(np.array(got), want)
    # logits that cancel the key's noise: every sum 0, a tie everywhere,
    # and both take the first index
    tie = -np.asarray(jax.random.gumbel(ks[7], (8,)))
    tie[4] = np.nextafter(tie[4], np.float32(1))  # ... or this one
    assert int(jax.random.categorical(ks[7], jnp.asarray(tie))) == 4
    assert int(prng.categorical(tks[7], torch.from_numpy(tie))) == 4
    tie[4] = -np.asarray(jax.random.gumbel(ks[7], (8,)))[4]
    assert int(jax.random.categorical(ks[7], jnp.asarray(tie))) == 0
    assert int(prng.categorical(tks[7], torch.from_numpy(tie))) == 0


# ---------------------------------------------------------------- corpus


@pytest.mark.parametrize("seed", [0, 1])
def test_markov_batches_token_equal(seed):
    ref = RefCorpus(vocab_size=97, seed=seed)
    port = MarkovCorpus(vocab_size=97, seed=seed, device="cpu")
    for step in (0, 7, 1000):
        want = np.asarray(ref.batch_at(step, 4, 32))
        got = port.batch_at(step, 4, 32)
        assert got.dtype == torch.int32 and got.shape == (4, 33)
        np.testing.assert_array_equal(got.numpy(), want)
        b, rb = make_lm_batch(port, step, 4, 32), ref_make_lm_batch(
            ref, step, 4, 32)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(rb[k]))


def test_markov_wide_vocab_and_tiny_vocab_token_equal():
    for V, seed in ((8192, 0), (5, 1)):
        want = np.asarray(RefCorpus(V, seed=seed).batch_at(3, 2, 40))
        got = MarkovCorpus(V, seed=seed, device="cpu").batch_at(3, 2, 40)
        np.testing.assert_array_equal(got.numpy(), want)


def test_markov_batch_is_pure_function_of_step():
    c = MarkovCorpus(vocab_size=97, seed=3, device="cpu")
    b1, b2, b3 = c.batch_at(5, 4, 16), c.batch_at(5, 4, 16), \
        c.batch_at(6, 4, 16)
    assert torch.equal(b1, b2) and not torch.equal(b1, b3)
    assert int(b1.min()) >= 0 and int(b1.max()) < 97


# ---------------------------------------------------------------- optim


@pytest.mark.parametrize("kind", ["cosine", "linear", "wsd"])
def test_schedules_match_reference(kind):
    kw = dict(peak_lr=3e-3, total_steps=150, warmup_steps=12)
    ref, port = ref_schedule(kind, **kw), make_schedule(kind, **kw)
    steps = np.arange(201)
    want = np.array([float(ref(s)) for s in steps], np.float32)
    got = np.array([float(port(int(s))) for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-7)
    # a 0-d int32 step tensor gives a 0-d float32 tensor on its device
    t = port(torch.tensor(40, dtype=torch.int32))
    assert t.dtype == torch.float32 and t.dim() == 0
    assert float(t) == pytest.approx(float(want[40]), rel=1e-7)
    # warm-up clamped to one step
    one = make_schedule(kind, peak_lr=1.0, total_steps=10, warmup_steps=0)
    assert float(one(0)) == pytest.approx(float(ref_schedule(
        kind, peak_lr=1.0, total_steps=10, warmup_steps=0)(0)), rel=1e-7)


def _opt_case(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": (5, 7), "b": (11,), "c": {"x": (3, 4, 2), "y": (6,)}}

    def tree(scale):
        return {k: ({kk: (rng.standard_normal(s) * scale).astype(np.float32)
                     for kk, s in v.items()} if isinstance(v, dict) else
                    (rng.standard_normal(v) * scale).astype(np.float32))
                for k, v in shapes.items()}
    return tree(1.0), tree(0.3), tree(0.1), tree(0.01)


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close_tree(got, want, tol):
    for g, w in zip(jax.tree.leaves(jax.tree.map(
            lambda t: t.float().numpy(), got)), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("m_dtype,master,clip", [
    ("float32", False, 1.0),   # the clip active (‖g‖ ≈ 3)
    ("float32", False, 100.0),  # the clip inactive
    ("bfloat16", True, 1.0),   # bf16 first moment, a float32 master copy
])
def test_adamw_update_matches_reference(m_dtype, master, clip):
    params, g1, m0, v0 = _opt_case(0)
    jdt, tdt = getattr(jnp, m_dtype), getattr(torch, m_dtype)
    rst = ref_adamw_init(jax.tree.map(jnp.asarray, params), m_dtype=jdt,
                         master=master)
    pst = adamw_init(_to_torch(params), m_dtype=tdt, master=master)
    rp, pp = jax.tree.map(jnp.asarray, params), _to_torch(params)
    for step, g in enumerate((g1, m0, v0)):  # three steps of grads
        lr = 1e-2 * (step + 1)
        rp, rst, rn = ref_adamw_update(rp, jax.tree.map(jnp.asarray, g),
                                       rst, lr=lr, grad_clip=clip)
        pp, pst, pn = adamw_update(pp, _to_torch(g), pst, lr=lr,
                                   grad_clip=clip)
        assert float(pn) == pytest.approx(float(rn), rel=1e-6)
        _close_tree(pp, rp, 1e-6)
        _close_tree(pst.m, rst.m, 1e-6)
        _close_tree(pst.v, rst.v, 1e-6)
        if master:
            _close_tree(pst.master, rst.master, 1e-6)
        assert int(pst.count) == int(rst.count) == step + 1
    assert next(iter(jax.tree.leaves(jax.tree.map(
        lambda t: t.dtype, pst.m)))) == tdt


def test_adamw_clip_and_decay_as_reference():
    """The reference's own checks (``tests/test_train.py``)."""
    params = {"w": torch.full((4,), 2.0)}
    st = adamw_init(params)
    p1, _, gnorm = adamw_update({"w": params["w"].clone()},
                                {"w": torch.full((4,), 100.0)}, st, lr=0.1,
                                grad_clip=1.0, weight_decay=0.0)
    assert float(gnorm) == pytest.approx(200.0)
    assert float(torch.max(torch.abs(p1["w"] - 2.0))) <= 0.11
    p2, _, _ = adamw_update({"w": params["w"].clone()},
                            {"w": torch.zeros(4)}, adamw_init(params),
                            lr=0.1, weight_decay=0.5)
    assert float(p2["w"][0]) < 2.0


@pytest.mark.parametrize("codec", ["topk", "int8"])
def test_compressed_grads_match_reference(codec):
    """Three steps of error feedback: what is sent and the residual,
    within 1e-7 (ties at the top-k threshold keep every tied entry)."""
    params, g1, g2, g3 = _opt_case(1)
    g2["b"][:4] = 0.25  # four equal magnitudes at the threshold
    rst = ref_compress_init(jax.tree.map(jnp.asarray, params))
    pst = compress_init(_to_torch(params))
    for g in (g1, g2, g3):
        rs, rst = ref_compressed(jax.tree.map(jnp.asarray, g), rst,
                                 codec=codec, topk_frac=0.2)
        ps, pst = compressed_grads(_to_torch(g), pst, codec=codec,
                                   topk_frac=0.2)
        _close_tree(ps, rs, 1e-7)
        _close_tree(pst.residual, rst.residual, 1e-7)


@pytest.mark.parametrize("codec", ["topk", "int8"])
def test_error_feedback_preserves_signal(codec):
    """The twin of the reference's: Σ sent + residual = Σ g, and the
    residual stays bounded."""
    rng = np.random.default_rng(0)
    st = compress_init({"w": torch.zeros(64)})
    total_g, total_sent = np.zeros(64), np.zeros(64)
    for _ in range(30):
        g = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
        total_g += g.numpy()
        sent, st = compressed_grads({"w": g}, st, codec=codec,
                                    topk_frac=0.1)
        total_sent += sent["w"].numpy()
    resid = st.residual["w"].numpy()
    np.testing.assert_allclose(total_sent + resid, total_g, rtol=1e-3,
                               atol=1e-3)
    assert np.linalg.norm(resid) < 0.8 * np.linalg.norm(total_g)
