"""Share of the wav2vec2 encoder's chunks whose forward was queued while an
earlier chunk's frames were still on their way to the host: the `ahead`
counts of the `encode_document.forward` spans inside the window's
`encode_document` spans over the number of those spans
(multimodaltopicsegmentation_torch/utils/profiling.py). Nothing when the
program records no such span, or no `ahead` count on one."""


def read(run):
    from multimodaltopicsegmentation_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    records = spans()
    t0, t1 = run.t0 * 1e9, run.loop_end * 1e9
    docs = {i for i, r in enumerate(records) if r.name == "encode_document"
            and r.end is not None and t0 <= r.start and r.end <= t1}
    ahead = [r.counts["ahead"] for r in records if r.name == "encode_document.forward"
             and r.parent in docs and "ahead" in r.counts]
    return 100.0 * sum(ahead) / len(ahead) if ahead else None
