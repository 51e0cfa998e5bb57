"""Share of the window's `fit` spans' host time outside their epochs (their
`fit.epoch` children, or `fit.window` ones where the epochs run in device
windows): building the tagger and its optimizer, copying the batches to the
device, the checkpoint and the gathering of the weights
(multimodaltopicsegmentation_torch/utils/profiling.py). Nothing when the
program records no such span."""

EPOCHS = ("fit.epoch", "fit.window")


def read(run):
    from multimodaltopicsegmentation_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    records = spans()
    t0, t1 = run.t0 * 1e9, run.loop_end * 1e9
    fits = {i for i, r in enumerate(records) if r.name == "fit"
            and r.end is not None and t0 <= r.start and r.end <= t1}
    total = sum(records[i].end - records[i].start for i in fits)
    epochs = sum(r.end - r.start for r in records if r.name in EPOCHS and r.parent in fits)
    return 100.0 * (total - epochs) / total if total and epochs else None
