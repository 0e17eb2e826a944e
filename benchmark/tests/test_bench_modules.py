"""No run holds JAX or the JAX package: the whole-name compare, a run's
own process, and the imports of the benchmark's sources."""
import ast
import glob
import os
import subprocess
import sys

import run


def test_whole_top_level_names():
    assert run.forbidden_modules(["mpp_tpu_torch", "mpp_tpu_torch.ops",
                                  "numpy", "mpp_tpu_torchx"]) == []
    assert run.forbidden_modules(["mpp_tpu", "mpp_tpu.ops.eos"]) == \
        ["mpp_tpu"]
    assert run.forbidden_modules(["jax.numpy", "jaxlib.xla_client",
                                  "flax.linen", "jaxtyping"]) == \
        ["flax", "jax", "jaxlib"]


def test_sources_import_no_forbidden_module():
    for path in glob.glob(os.path.join(run.HERE, "**", "*.py"),
                          recursive=True):
        if os.sep + "tests" + os.sep in path:
            continue
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert run.forbidden_modules(names) == [], (path, names)


def test_a_run_loads_none(tmp_path):
    """A whole run (small, on the CPU) in a process of its own: after its
    window and judgement its modules hold no forbidden top-level name."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import run\n"
        "res = run.run_cell('vsfm_vchannel.direct', 7, 0.0, 0, "
        "device='cpu', overrides={'nz': 3})\n"
        "assert res['correct'], res\n"
        "print('FOUND', run.forbidden_modules())\n"
        % (run.HERE, run.ROOT))
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FOUND []" in out.stdout


def test_no_result_without_a_card():
    """Without a card the run exits non-zero and prints no result."""
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, os.path.join(run.HERE, "run.py"), "--workload",
         "vsfm_vchannel.direct", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
