"""Host milliseconds of `encode_document` (its span ends with the frames on
the host) per thousand units encoded."""


def read(run):
    units = run.span_units.get("encode", 0)
    return 1e3 * run.spans["encode"] / (units / 1e3) if units else None
