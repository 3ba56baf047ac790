"""The port stands alone: it imports neither JAX nor anything of
``br_tpu``, and its entry points never fall back to the CPU on their own.
"""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
import br_tpu_torch, br_tpu_torch.cli, br_tpu_torch.runtime
import br_tpu_torch.profiling, br_tpu_torch.set, br_tpu_torch.correct
import br_tpu_torch.correct.engine3, br_tpu_torch.corpus, br_tpu_torch.kernels
import br_tpu_torch.correct.two, br_tpu_torch.correct.walk
import br_tpu_torch.correct.greedy, br_tpu_torch.correct.reference
import br_tpu_torch.correct.alignment
import br_tpu_torch.native, br_tpu_torch.native.build
import br_tpu_torch.set.device_build, br_tpu_torch.set.hash
import br_tpu_torch.correct.hash_probe
import br_tpu_torch.parallel, br_tpu_torch.parallel.mesh
import br_tpu_torch.parallel.multihost
import chip_smoke
sys.path.insert(0, 'tests')
import torch_cases  # chip_smoke.long_walk_chunk draws its chunk with it
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'br_tpu'))
print(' '.join(bad))
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax_and_no_br_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, (r.stdout, r.stderr)


def test_default_device_is_cuda_and_never_the_cpu(monkeypatch, tmp_path,
                                                   capsys):
    """Without CUDA, device=None raises instead of running on the CPU."""
    from br_tpu_torch.cli import main
    from br_tpu_torch.correct.engine3 import Torch3Corrector, resolve_device
    from br_tpu_torch.runtime import make_corrector, run_correction
    from br_tpu_torch.set.solid import SolidSet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    solid = SolidSet.from_sequences([b"ACGTTGCAAGGCTTAC" * 4], 13)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        Torch3Corrector(solid, ["one"], 5, 7)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_corrector(solid, ["one"], 5, 7)
    fa = tmp_path / "r.fa"
    fa.write_bytes(b">r\nACGTTGCAAGGCTTACACGT\n")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_correction([str(fa)], [str(tmp_path / "o.fa")], solid, ["one"],
                       5, 7, False)
    assert main(["-i", str(fa), "-o", str(tmp_path / "o.fa"), "-c", "one",
                 "fasta", "-i", str(fa), "-k", "13", "-a", "0"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
    assert not (tmp_path / "o.fa").exists()
    assert resolve_device("cpu") == torch.device("cpu")
