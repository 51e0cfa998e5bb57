"""The port stands alone: no module of multimodaltopicsegmentation_torch, and
not chip_smoke.py, imports JAX or the JAX package."""
import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_modules_import_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import multimodaltopicsegmentation_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "assert len(names) > 20, names\n"
        "for new in ('ops.flash_attention', 'ops.attention', 'models.transformers',\n"
        "            'models.registry', 'ops.losses', 'eval.metrics', 'train.data',\n"
        "            'train.loop', 'cli.train_fit', 'ops.crf', 'ops.cosine_loss',\n"
        "            'models.taggers', 'utils.profiling', 'dsp.unitize', 'dsp.spectral',\n"
        "            'dsp.yin', 'dsp.pyin', 'dsp.prosody', 'dsp.vad', 'encoders.crdnn_vad',\n"
        "            'encoders.tdnn', 'encoders.openl3', 'encoders.crepe', 'encoders.engine',\n"
        "            'cli.extract_embeddings', 'cli.extract_embeddings_inference',\n"
        "            'cli.predict', 'train.device_fit', 'train.grid'):\n"
        "    assert pkg.__name__ + '.' + new in names, new\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'multimodaltopicsegmentation_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, env=env, timeout=300)


def test_chip_smoke_imports_only_torch_numpy_and_the_port():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "multimodaltopicsegmentation_tpu"}
    assert "multimodaltopicsegmentation_torch" in roots


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without CUDA the script exits non-zero and prints no result line."""
    import torch

    if torch.cuda.is_available():
        import pytest

        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
