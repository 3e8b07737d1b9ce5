"""What the program assumes about the machine it runs on: the device peak
table, the compile-cache location, the dependency set of the main path,
and that chip_smoke.py refuses to run without a GPU."""

import json
import os
import subprocess
import sys
import types

import jax
import pytest

from custom_op_benchmark_tpu.parallel import budget
from custom_op_benchmark_tpu.utils import benchlib, cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_peak_bandwidth_table_finds_h100_by_reported_kind():
    dev = types.SimpleNamespace(device_kind="NVIDIA H100 80GB HBM3")
    assert benchlib.hbm_bandwidth_bytes(dev) == 3.35e12


@pytest.mark.parametrize("kind", ["cpu", "Some Accelerator v1",
                                  "NVIDIA A100-SXM4-80GB", None])
def test_peak_bandwidth_table_rejects_unknown_devices(kind):
    with pytest.raises(ValueError, match="no peak bandwidth"):
        benchlib.hbm_bandwidth_bytes(
            types.SimpleNamespace(device_kind=kind))


def test_budget_capacity_defaults_to_h100_and_reads_devices():
    assert budget.device_capacity_bytes(
        types.SimpleNamespace(memory_stats=lambda: None)) == 80e9
    dev = types.SimpleNamespace(
        memory_stats=lambda: {"bytes_limit": 60e9})
    assert budget.device_capacity_bytes(dev) == 60e9


def test_compile_cache_honours_env_var(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.compile_cache_dir() == str(tmp_path)
    assert cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets no other directory.
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert cache.compile_cache_dir() == want
    assert cache.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_main_path_runs_without_flax_or_orbax():
    """Import the package and train one full-graph epoch with flax and
    orbax made unimportable."""
    code = """
import sys
sys.modules["flax"] = None
sys.modules["orbax"] = None
import custom_op_benchmark_tpu
from custom_op_benchmark_tpu.data import planted_partition
from custom_op_benchmark_tpu.models import GAT
from custom_op_benchmark_tpu.train import fit_full_graph
ds = planted_partition(num_classes=3, nodes_per_class=20, feat_dim=8,
                       seed=0)
_, m = fit_full_graph(GAT(hidden_dim=8, out_dim=3, num_heads=2), ds,
                      epochs=1)
assert m["val_acc"] == m["val_acc"]
assert not any(k.split(".")[0] in ("flax", "orbax")
               for k, v in sys.modules.items() if v is not None)
print("NOFLAX OK")
"""
    out = subprocess.run([sys.executable, "-c", code], env=_cpu_env(),
                         cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NOFLAX OK" in out.stdout


def _last_json(stdout):
    lines = [l for l in stdout.strip().splitlines() if l.strip()]
    if not lines:
        return None
    try:
        return json.loads(lines[-1])
    except ValueError:
        return None


def test_chip_smoke_refuses_cpu_before_compiling():
    out = subprocess.run([sys.executable, "chip_smoke.py"], env=_cpu_env(),
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "needs an NVIDIA GPU" in out.stderr
    assert "phase" not in out.stdout
    assert _last_json(out.stdout) is None


def test_chip_smoke_alone_fails(tmp_path):
    """Copied out of the repository, the script has nothing to run."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    env = _cpu_env()
    env["PYTHONPATH"] = ""
    out = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert _last_json(out.stdout) is None
