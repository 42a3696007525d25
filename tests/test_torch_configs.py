"""``repro_torch.configs`` — the port's own copy of the reference's
pure-Python configs — equals ``repro.configs`` for every arch: the full
and smoke configs field by field, ``n_params``, ``n_active_params``, the
schedule hint, ``SHAPES`` and ``cells_for_arch``; and it imports neither
jax nor ``repro``."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.configs as rc
from repro.configs.registry import get_schedule as ref_schedule
import repro_torch.configs as tc
from repro_torch.configs.registry import get_schedule

SRC = Path(__file__).resolve().parents[1] / "src"


def test_arch_ids_match():
    assert tc.ARCHS == rc.ARCHS and len(tc.ARCHS) == 10


@pytest.mark.parametrize("arch", rc.ARCHS)
def test_configs_match_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        want, got = getattr(rc, get)(arch), getattr(tc, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.n_params() == want.n_params()
        assert got.n_active_params() == want.n_active_params()
        for prop in ("d_inner", "ssm_heads", "is_encdec",
                     "is_attention_free"):
            assert getattr(got, prop) == getattr(want, prop)
        assert ([s.name for s in tc.cells_for_arch(got)]
                == [s.name for s in rc.cells_for_arch(want)])
    assert get_schedule(arch) == ref_schedule(arch)


def test_shapes_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in tc.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in rc.SHAPES.items()}


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        tc.get_config("no-such-arch")


def test_configs_and_models_import_no_jax():
    code = ("import sys\n"
            "import repro_torch.configs, repro_torch.models\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=str(SRC)),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
