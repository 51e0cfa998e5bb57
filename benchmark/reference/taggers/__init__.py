"""The plain reference of each tagger architecture, one module per name
(`<architecture>.py`, the name the configurations' `tagger.architecture`
gives). Each module has:

- `leaves(tc)`: the [(path, shape, std, mean)] of the JAX-layout weights
  the benchmark draws from the seed;
- `initial_params(tc, seed)`: the first weights a trainer seeded with `seed`
  draws, JAX layout, on the CPU;
- `logits(params, x, lengths, tc)`: x [B, L, d] of padded rows -> [B, L],
  each row at its own length (what lies past it is not read).
"""
import importlib


def load(architecture: str):
    """The module of `architecture`; a ValueError when there is none."""
    try:
        return importlib.import_module(f"{__name__}.{architecture}")
    except ModuleNotFoundError as e:
        if e.name != f"{__name__}.{architecture}":
            raise
        raise ValueError(f"no plain reference for the architecture {architecture!r} "
                         f"(reference/taggers/{architecture}.py)") from None
