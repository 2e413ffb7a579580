"""chip_smoke.py's phases at tiny sizes on the CPU, each against its
reference, and its refusal to report anything without a GPU.  (On the
CPU ``engine="auto"`` takes the XLA engine, so the kernel-vs-XLA legs
compare the engine with itself here; the f64 legs are real.)"""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402


def test_phase_geomorphons_and_openness():
    Z = cs.phase_geomorphons(0, shape=(150, 170), lookup=6, win=32,
                             n_win=2)
    assert Z.shape == (150, 170)
    cs.phase_openness(Z, lookup=6)


def test_phase_smrf():
    cs.phase_smrf(0, extent=80.0, density=4.0, crop=40.0)


def test_synthetic_tile_labels():
    x, y, z, label = cs.synthetic_tile(3, extent=120.0, density=2.0)
    assert x.size == y.size == z.size == label.size == 28800
    assert set(label.tolist()) == {1, 2}
    assert 0.02 < (label == 1).mean() < 0.8


def test_phase_mosaic():
    cs.phase_mosaic(0, side=96, tile=32, lookup=4)


def test_phase_stats():
    cs.phase_stats(0, side=96, radius=5, win=16)


def test_phase_gridding():
    cs.phase_gridding(0, n=20000, extent=50.0)


def test_phase_four_on_virtual_devices():
    """The mesh paths on 4 of the 8 virtual CPU devices."""
    cs.phase_four(0, shape=(64, 80), lookup=4, extent=40.0, density=2.0,
                  mosaic_side=96, mosaic_tile=32)


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, cwd=cwd, env=env, timeout=300)


def test_exits_nonzero_without_gpu():
    r = _run(["chip_smoke.py"], REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_fails_alone_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.gpu
def test_smoke_phases_on_card(gpu):
    """Geomorphons and openness at 2048^2 on the card."""
    Z = cs.phase_geomorphons(0, shape=(2048, 2100), lookup=50, win=256,
                             n_win=1)
    cs.phase_openness(Z)
