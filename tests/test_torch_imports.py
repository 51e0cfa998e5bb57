"""The port stands alone: no module of multimodaltopicsegmentation_torch, and
not chip_smoke.py, imports JAX or the JAX package; importing every port
module loads none of sklearn, pandas, nltk and pygame (the card's machine
has none of them) and builds nothing."""
import ast
import os
import subprocess
import sys

import pytest
import torch

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
        "            'cli.predict', 'train.device_fit', 'train.grid', 'parallel.mesh',\n"
        "            'parallel.train_step', 'parallel.sequence', 'parallel.pipeline',\n"
        "            'parallel.expert', 'parallel.multihost', 'parallel.dryrun',\n"
        "            'parallel.tensor',\n"
        "            'runtime.audio_native', 'utils.text_corpora', 'utils.logging_utils',\n"
        "            'utils.sklearn_pickle', 'tools.convert_reference_checkpoint',\n"
        "            'cli.compute_accuracy_metrics_sentence'):\n"
        "    assert pkg.__name__ + '.' + new in names, new\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'multimodaltopicsegmentation_tpu')]\n"
        "assert not bad, bad\n"
        "absent = [m for m in sys.modules if m.split('.')[0] in\n"
        "          ('sklearn', 'pandas', 'nltk', 'pygame')]\n"
        "assert not absent, absent\n"
        "from multimodaltopicsegmentation_torch.core import cuda_build\n"
        "from multimodaltopicsegmentation_torch.runtime import audio_native\n"
        "assert cuda_build._loaded == {} and cuda_build._host == {}\n"
        "assert audio_native._lib is None\n"
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


@pytest.mark.cuda
def test_two_spawned_ranks_share_one_card(tmp_path):
    """Two ranks on the first card (gloo: more ranks than cards), the
    sequence-sharded Transformer through the flash kernels: logits, loss and
    gradients equal to one process's plain forward on the card (1e-4), and
    the halos staged through host memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np

    import torch_dist_workers as W
    from multimodaltopicsegmentation_torch.models.base import TaggerConfig
    from multimodaltopicsegmentation_torch.models import registry
    from multimodaltopicsegmentation_torch.parallel.dryrun import spawn_ranks

    cfg = dict(embedding_dim=64, hidden_dim=32, num_layers=2, nheads=4, attention_window=16,
               loss_fn="FocalLoss")
    model = registry.build("Transformer", TaggerConfig(**cfg), torch.Generator().manual_seed(0))
    params = model.to_jax_params()
    rng = np.random.default_rng(0)
    lengths = np.array([256, 100, 140, 7], np.int32)
    x = rng.standard_normal((4, 256, 64)).astype(np.float32)
    tags = (rng.random((4, 256)) < 0.1).astype(np.float32)
    tags[np.arange(256)[None, :] >= lengths[:, None]] = -1.0
    env = dict(CUDA_VISIBLE_DEVICES=os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0])
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        spawn_ranks(W.card_case, 2, (str(tmp_path), cfg, params, x, lengths, tags), "cuda",
                    timeout=600, store_dir=str(tmp_path))
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    dev = torch.device("cuda")
    model = model.to(dev)
    xs, ls, ts = (torch.as_tensor(a).to(dev) for a in (x, lengths, tags))
    logits = model.scores(xs, ls)
    loss = model.loss(xs, ls, ts)
    loss.backward()
    valid = np.arange(256)[None, :] < lengths[:, None]
    for r in W.load(str(tmp_path), 2):
        assert r["backend"] == "gloo" and r["device"] == "cuda:0" and r["staged"] > 0
        np.testing.assert_allclose(r["logits"][valid], logits.detach().cpu().numpy()[valid],
                                   atol=1e-4, rtol=0)
        assert abs(r["loss"] - loss.item()) <= 1e-4
        for n, p in model.named_parameters():
            np.testing.assert_allclose(r["grads"][n], p.grad.cpu().numpy(), atol=1e-4, rtol=0,
                                       err_msg=n)
