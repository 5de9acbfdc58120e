"""The import guard: top-level names compared whole."""

import subprocess
import sys

from portbench import guard
from portbench.harness import ROOT


def test_sources_import_neither_jax_nor_the_jax_package():
    assert guard.scan() == []


def test_names_are_compared_whole():
    assert guard.loaded(["speech_tranformer_pytorch_tpu_torch.models", "numpy"]) == []
    assert guard.loaded(["speech_tranformer_pytorch_tpu.models"]) == ["speech_tranformer_pytorch_tpu"]
    assert guard.loaded(["jax.numpy", "jaxlib.xla_client", "flax"]) == ["flax", "jax", "jaxlib"]
    assert guard.loaded(["jaxtyping"]) == []


def test_the_reference_may_not_import_the_port(tmp_path):
    ref = tmp_path / "reference"
    ref.mkdir()
    (ref / "x.py").write_text("from speech_tranformer_pytorch_tpu_torch import config\n")
    (tmp_path / "y.py").write_text("import speech_tranformer_pytorch_tpu_torch\nimport jax.numpy\n")
    bad = guard.scan(str(tmp_path))
    assert any("reference" in b and "_torch" in b for b in bad)
    assert any("y.py imports jax" in b for b in bad)
    assert not any("y.py" in b and "_torch" in b for b in bad)


def test_a_run_loads_no_jax():
    """A tiny serving and training run on the CPU, then the loaded modules."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench.tests.conftest import tiny_context\n"
            "from portbench.drivers import serve, train\n"
            "serve.run(tiny_context('serve', seconds=0.2)); train.run(tiny_context('train', seconds=0.2))\n"
            "from portbench import guard; print(guard.loaded())\n") % (ROOT + "/..",)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
