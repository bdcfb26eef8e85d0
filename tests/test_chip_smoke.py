"""chip_smoke.py: its phases at tiny sizes against their float64 references,
and its refusal to report success without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

import jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

# tiny stand-ins for the card-sized phases; each raises if its check fails
PHASES = {
    "A": lambda d: chip_smoke.phase_a(n=12, steps=3, result_dir=d),
    "B": lambda d: chip_smoke.phase_b(n=16, steps=3),
    "C": lambda d: chip_smoke.phase_c(n=12, steps=2, result_dir=d),
    "D": lambda d: chip_smoke.phase_d(n=8, steps=2, explicit_steps=4, result_dir=d),
    "D2": lambda d: chip_smoke.phase_d2(n=8, steps=2, result_dir=d),
    "E": lambda d: chip_smoke.phase_e(n=4, steps=2, result_dir=d),
    "four-transport": lambda d: chip_smoke.phase_four_transport(n=16, steps=2, result_dir=d),
    "four-rows": lambda d: chip_smoke.phase_four_wave(n=8, result_dir=d),
}


@pytest.mark.parametrize("phase", list(PHASES))
def test_phase_meets_its_reference(phase, tmp_path):
    recs = PHASES[phase](str(tmp_path))
    for rec in recs if isinstance(recs, list) else [recs]:
        errs = [v for k, v in rec.items() if k.startswith(("rel_l2", "residual"))]
        assert errs and max(errs) <= rec["tol"]


def test_require_gpu_refuses_cpu_devices():
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu(jax.devices(), 1)


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_no_ok_line_without_gpu(alone, tmp_path):
    """Without a GPU (here) or without the rest of the repo, the script exits
    non-zero and prints no verdict."""
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if alone:
        cwd = str(tmp_path)
        script = shutil.copy(script, cwd)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.gpu
def test_phases_on_gpu(tmp_path):
    """The tiny phases on the card (skips where JAX finds no GPU)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("no GPU")
    for name in ("A", "B", "C", "D", "D2", "E"):
        PHASES[name](str(tmp_path))
