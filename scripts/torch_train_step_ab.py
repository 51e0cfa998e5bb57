"""Median train-step time of the PyTorch port's BiLSTM and Transformer
taggers at the flagship shape (one batch of 10 x 3600 units, 768 -> 256 x 2,
8 heads, window 120, FocalLoss, Adam, 20 steps, CUDA events over steps 3 on),
in one or more checkouts of the repo, each in a fresh process, in the order
given:

    python scripts/torch_train_step_ab.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout that holds chip_smoke.py; its own
package, kernels and helpers are used. Needs one card. Prints one JSON line
per run and, at the end, the card's name and power limit.
"""
import json
import os
import shutil
import subprocess
import sys


def one(root: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from multimodaltopicsegmentation_torch.core import cuda_build
    from multimodaltopicsegmentation_torch.train.data import batches
    from multimodaltopicsegmentation_torch.train.loop import Trainer

    cuda_build.build_all(("flash_local_attention", "flash_local_attention_bwd"))
    corpus = os.path.join(cs.WORK, "step_ab_corpus")
    shutil.rmtree(corpus, ignore_errors=True)  # an earlier run's, in the same checkout
    _, _, _, docs = cs.write_corpus(corpus, cs.TRAIN_UNITS, seed=0)
    train_batches = list(batches(docs, 10, crf=False, truncate=True, truncate_value=3600))
    out = {"root": root}
    for arch in ("BiLSTM", "Transformer"):
        trainer = Trainer(arch, cs.training_config(), lr=1e-3, max_epochs=cs.TRAIN_EPOCHS,
                          no_early_stop=True, monitor="training_loss",
                          check_dir=os.path.join(cs.WORK, f"step_ab_{arch}"), seed=0, device="cuda")
        out[arch] = cs.timed_fit(trainer, train_batches)[4]
    return out


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(one(sys.argv[2])))
        return 0
    for root in sys.argv[1:]:
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                             stdout=subprocess.PIPE, text=True, check=True)
        print(run.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
