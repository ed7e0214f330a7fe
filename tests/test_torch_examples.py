"""The port's example twins run end to end on the CPU (``--device cpu``,
quick sizes), in a subprocess as ``tests/test_examples.py`` runs the JAX
package's."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    # the test workers share the machine's cores: one OpenMP thread keeps
    # the example's torch from spinning against the other workers
    env.setdefault("OMP_NUM_THREADS", "1")
    out = subprocess.run([sys.executable] + args, env=env, timeout=timeout,
                         capture_output=True, text=True, cwd=REPO)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    return out.stdout


@pytest.mark.parametrize("script,args,expect", [
    ("examples/torch_quickstart.py", ["--n0", "64", "--levels", "4"],
     ["covariance errors vs exact GP", "1,024-point sample"]),
    ("examples/torch_gp_regression_cg.py", ["--samples", "8"],
     ["cg_posterior:", "conditioned posterior served OK"]),
    ("examples/torch_gp_regression_vi.py", ["--quick"],
     ["MAP: 40 steps", "ADVI: 20 steps", "posterior fitted and served OK"]),
    ("examples/torch_dust_map_3d.py", ["--quick", "--shards", "8"],
     ["route=nd-fused", "fused VJP", "distributed over 8 slots",
      "rel-err vs unsharded", "corr(shell0, shell1)"]),
    ("examples/torch_serve_lm.py", ["--arch", "gemma3-4b"],
     ["req5: prompt=", "decode tok/s, gemma3-4b reduced, cpu"]),
    ("examples/torch_lm_train.py",
     ["--steps", "12", "--batch", "4", "--seq-len", "32"],
     ["step 10: loss=", "starcoder2-15b (reduced, cpu): loss",
      "over 12 steps"]),
], ids=["quickstart", "gp_regression_cg", "gp_regression_vi", "dust_map_3d",
        "serve_lm", "lm_train"])
def test_torch_example_runs_on_the_cpu(script, args, expect):
    out = _run([script, "--device", "cpu", *args])
    for line in expect:
        assert line in out, out
