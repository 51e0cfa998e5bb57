"""Kilobytes the encoder brings back to the host per unit encoded: the
`bytes_to_host` of the `encode_document.to_host` spans inside the window's
`encode_document` spans, over the `units` those count
(multimodaltopicsegmentation_torch/utils/profiling.py). Nothing when the
program records no such span."""


def read(run):
    from multimodaltopicsegmentation_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    records = spans()
    t0, t1 = run.t0 * 1e9, run.loop_end * 1e9
    docs = {i for i, r in enumerate(records) if r.name == "encode_document"
            and r.end is not None and t0 <= r.start and r.end <= t1}
    units = sum(records[i].counts.get("units", 0) for i in docs)
    sent = sum(r.counts.get("bytes_to_host", 0) for r in records
               if r.name == "encode_document.to_host" and r.parent in docs)
    return sent / units / 1e3 if units and sent else None
