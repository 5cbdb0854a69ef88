"""chip_smoke.py and the compile-cache helper, rehearsed on the CPU.

Each smoke phase runs here at a tiny size — the whole-tree kernel in the
Pallas interpreter — so its paths, arguments and checks are exercised
before a card sees them; ``main()`` must refuse to run without a GPU.
The compiled phases at full size run on a card (the ``gpu`` test).
"""

import json
import os
import subprocess
import sys

import pytest

import chip_smoke as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_phase_single_node_tiny():
    cs.phase_single_node(0, n_dna=1000, n_prot=300)


def test_phase_tree_tiny_kernel_interpreted():
    cs.phase_tree(0, taxa=6, sites=300, golden_sites=128, interpret=True)


def test_phase_training_tiny():
    cs.phase_training(0, taxa=6, sites=256, cmp_taxa=5, cmp_sites=128)


def test_phase_protein_tiny():
    cs.phase_protein(0, taxa=5, sites=256, check_sites=64)


def test_phase_search_tiny():
    cs.phase_search(0, taxa=8, sites=256, pipe_taxa=6, pipe_sites=300)


def test_phase_four_tiny_kernel_interpreted():
    cs.phase_four(0, taxa=6, sites=1024, interpret=True)


def test_check_helpers_raise():
    assert cs._check("x", [1.0, 2.0], [1.0, 2.0 + 1e-9], 1e-6, 0.0) < 1e-6
    with pytest.raises(AssertionError, match="beyond rtol"):
        cs._check("x", [1.0, 2.1], [1.0, 2.0], 1e-6, 0.0)
    with pytest.raises(AssertionError, match="non-finite"):
        cs._check("x", [float("nan")], [1.0], 1e-6, 0.0)
    with pytest.raises(AssertionError, match="differs"):
        cs._equal("x", [1, 2], [1, 3])


def test_main_refuses_without_gpu(capsys):
    assert cs.main([]) != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "no GPU" in out.err


def test_script_alone_fails_without_the_package(tmp_path):
    """In a directory holding only chip_smoke.py the script exits
    non-zero and prints no result."""
    script = tmp_path / "chip_smoke.py"
    script.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.gpu
def test_smoke_on_gpu(gpu):
    """The full one-card smoke run, compiled, on a card."""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"


# ----------------------------------------------------- compile cache ---

def _cache_dir_after(env_value):
    """The cache directory a fresh process ends up with."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    code = ("import jax\n"
            "from plf_tpu.utils.compile_cache import enable_compile_cache\n"
            "used = enable_compile_cache()\n"
            "print(used, jax.config.jax_compilation_cache_dir)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_compile_cache_honours_env(tmp_path):
    used, configured = _cache_dir_after(str(tmp_path / "cache"))
    assert used == configured == str(tmp_path / "cache")


def test_compile_cache_default_is_fixed_in_checkout():
    from plf_tpu.utils.compile_cache import DEFAULT_CACHE_DIR
    used, configured = _cache_dir_after(None)
    assert used == configured == str(DEFAULT_CACHE_DIR)
    assert DEFAULT_CACHE_DIR.parent == __import__("pathlib").Path(ROOT)
    ignored = open(os.path.join(ROOT, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored
