"""The port's multi-host start-up (parallel/multihost.py): two processes
join one gloo group from MTS_COORDINATOR (a file:// store) /
MTS_NUM_PROCESSES / MTS_PROCESS_ID, each reads its round-robin share of a
5-document ragged corpus (3 and 2 documents), lifts it into an equal-shape
local batch and takes two data-parallel Adam steps. Both report the same
losses and parameters, equal to the JAX package's single-device steps on
the concatenated batch (losses 1e-5, parameters 1e-4).
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

import torch_dist_workers as W
from multimodaltopicsegmentation_tpu.models import registry as jax_registry
from multimodaltopicsegmentation_tpu.models.base import TaggerConfig as JaxTaggerConfig
from multimodaltopicsegmentation_tpu.train.loop import make_optimizer as jax_optimizer
from multimodaltopicsegmentation_torch.parallel import multihost

pytestmark = pytest.mark.torch_distributed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))


def _corpus():
    """The workers' corpus: 5 documents of 16, 13, 10, 7 and 4 units."""
    rng = np.random.default_rng(0)
    L, D = 16, 12
    return [(rng.standard_normal((L - 3 * i, D)).astype(np.float32),
             (rng.random(L - 3 * i) < 0.2).astype(np.float32)) for i in range(5)]


def _jax_steps(params, steps=2):
    """One device, the concatenated batch (rank 0's documents, then rank 1's)."""
    docs = _corpus()
    order = [0, 2, 4, 1, 3]
    x = np.zeros((5, 16, 12), np.float32)
    tags = np.full((5, 16), -1.0, np.float32)
    lengths = np.zeros(5, np.int32)
    for row, i in enumerate(order):
        n = len(docs[i][0])
        x[row, :n], tags[row, :n], lengths[row] = docs[i][0], docs[i][1], n
    cfg = JaxTaggerConfig(embedding_dim=12, hidden_dim=8, num_layers=1, loss_fn="FocalLoss")
    jarch = jax_registry.build("BiLSTM", cfg)
    tx = jax_optimizer("Adam", 1e-3)
    state = tx.init(params)
    vg = jax.jit(jax.value_and_grad(
        lambda p: jarch.loss(p, jnp.asarray(x), jnp.asarray(lengths), jnp.asarray(tags))))
    losses = []
    for _ in range(steps):
        loss, g = vg(params)
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return losses, params


def test_two_processes_match_one_process_on_the_concatenated_batch(tmp_path):
    cfg = JaxTaggerConfig(embedding_dim=12, hidden_dim=8, num_layers=1, loss_fn="FocalLoss")
    params = jax.tree.map(np.asarray,
                          jax_registry.build("BiLSTM", cfg).init(jax.random.PRNGKey(0)))
    with open(tmp_path / "params.pkl", "wb") as f:
        pickle.dump(params, f)
    code = (f"import sys; sys.path[:0] = [{TESTS!r}, {ROOT!r}]\n"
            f"import torch_dist_workers as W; W.multihost_main({str(tmp_path)!r})\n")
    procs = []
    try:
        for pid in range(2):
            env = {k: v for k, v in os.environ.items()
                   if k not in ("PYTHONSTARTUP", "WORLD_SIZE", "RANK", "MASTER_ADDR")}
            env.update(MTS_COORDINATOR="file://" + str(tmp_path / "store"),
                       MTS_NUM_PROCESSES="2", MTS_PROCESS_ID=str(pid))
            procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:  # a rank left waiting at the store must not outlive the test
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        assert "backend gloo" in out
    ranks = W.load(str(tmp_path), 2)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    # equal-shape local batches: 3 documents (rank 1 pads one), 16 units
    assert ranks[0]["shape"] == ranks[1]["shape"] == (3, 16, 12)
    assert ranks[0]["n_global"] == ranks[1]["n_global"] == 5
    want_losses, want_params = _jax_steps(params)
    np.testing.assert_allclose(ranks[0]["losses"], want_losses, atol=1e-5, rtol=0)
    for r in ranks:
        for g, w in zip(jax.tree.leaves(r["params"]), jax.tree.leaves(want_params)):
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=0)


def test_shard_documents_round_robin_and_initialize_needs_a_cluster(monkeypatch):
    docs = list(range(7))
    assert multihost.shard_documents(docs, 0, 2) == [0, 2, 4, 6]
    assert multihost.shard_documents(docs, 1, 2) == [1, 3, 5]
    assert multihost.shard_documents(docs) == docs  # one process, no group
    for key in ("MTS_COORDINATOR", "MTS_NUM_PROCESSES", "MTS_PROCESS_ID", "MASTER_ADDR",
                "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="needs a coordinator"):
        multihost.initialize(device="cpu")
    with multihost.process_group_from_environment("cpu"):  # WORLD_SIZE unset: nothing to join
        from multimodaltopicsegmentation_torch.parallel.mesh import world_size

        assert world_size() == 1
