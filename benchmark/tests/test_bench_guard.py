"""The guard keeps JAX and the JAX package out, by whole top-level name."""

import subprocess
import sys

import pytest

from benchmark import guard, harness


@pytest.mark.parametrize("name, blocked", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("saprobe_alac_tpu", True), ("saprobe_alac_tpu.ops.batch", True),
    ("saprobe_alac_tpu_torch", False), ("saprobe_alac_tpu_torch.ops.batch", False),
    ("jaxtyping", False), ("numpy", False),
])
def test_top_level_name_compared_whole(name, blocked):
    assert guard.is_blocked(name) is blocked


def test_loaded_names_the_blocked_top_levels():
    mods = ["saprobe_alac_tpu_torch", "saprobe_alac_tpu_torch.ops", "numpy", "jax._src.core"]
    assert guard.loaded(mods) == ["jax"]
    assert guard.loaded(mods[:3]) == []


def test_installed_block_refuses_the_import_and_lets_the_port_in():
    code = (
        "import sys; sys.path.insert(0, '.'); from benchmark import guard; guard.install()\n"
        "import saprobe_alac_tpu_torch\n"
        "for name in ('jax', 'saprobe_alac_tpu', 'saprobe_alac_tpu.decoder'):\n"
        "    try:\n"
        "        __import__(name)\n"
        "    except ImportError:\n"
        "        continue\n"
        "    raise SystemExit(f'{name} was imported')\n"
        "assert guard.loaded() == [], guard.loaded()\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def test_run_exits_without_a_card_and_prints_nothing(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "cd16_stereo.batch2048",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""
