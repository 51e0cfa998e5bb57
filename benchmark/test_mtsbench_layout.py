"""BENCHMARK.json against the harness: every cell, configuration, traffic mix,
metric and limit is found by name, and nothing the benchmark runs imports
JAX or the JAX package."""
import ast
import json
import os
import re
import subprocess
import sys

import pytest

from mtsbench import spec

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCH = spec.load_benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

sys.path.insert(0, HERE)
import run  # noqa: E402


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(workload):
    from mtsbench import harness
    from reference import taggers

    cell = spec.load_cell(workload, ROOT)
    assert issubclass(spec.driver(cell.traffic["kind"]), harness.Driver)
    arch = cell.config["tagger"]["architecture"]
    assert callable(spec.architecture(arch).flops) and callable(taggers.load(arch).logits)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    for m in cell.end_to_end:
        assert m["name"] == "setup_s" or callable(spec.metric_reader(m["name"]))
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert m["moves"] in names
        assert callable(spec.metric_reader(m["name"]))
    assert cell.limits and all(v >= 0 for v in cell.limits.values())


# Cells kept out of BENCHMARK.json until their runs are steady (PERF.md, Open
# questions): their mixes, limits and readers stay, so that entries alone bring
# each back.
PARKED = {
    "w2v2base_bilstm.train_sentences": ["train_sentences_per_s", "lstm_device_share.train_sentences",
                                        "epoch_ms_median.train_sentences", "mfu.train_sentences",
                                        "idle_share.train_sentences"],
    "transformer_longdoc.predict_1s": ["predict_1s_units_per_s", "glue_share.predict_1s",
                                       "decode_ms_per_kunit.predict_1s", "flash_roofline.predict",
                                       "mfu.predict_1s", "idle_share.predict_1s"],
}


@pytest.mark.parametrize("workload", sorted(PARKED))
def test_parked_cell_comes_back_by_entries_alone(workload):
    from mtsbench import harness

    config, mix = workload.split(".")
    bench = dict(BENCH, workloads=BENCH["workloads"] + [
        {"name": workload, "config": config, "traffic": mix, "chips": 1, "why": "parked"}])
    cell = spec.load_cell(workload, ROOT, bench)
    assert issubclass(spec.driver(cell.traffic["kind"]), harness.Driver)
    assert cell.limits
    for name in PARKED[workload]:
        assert callable(spec.metric_reader(name))


def test_unknown_names_are_refused():
    from reference import taggers

    for load in (spec.driver, spec.architecture, spec.metric_reader, taggers.load):
        with pytest.raises(ValueError, match="NoSuch"):
            load("NoSuch")


def test_names_units_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
        assert w["chips"] == 1
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
             + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)


def test_jax_check_compares_whole_top_level_names():
    loaded = ["multimodaltopicsegmentation_torch", "multimodaltopicsegmentation_torch.ops",
              "jaxtyping", "flaxen", "jax", "jax.numpy", "jaxlib.xla_client",
              "multimodaltopicsegmentation_tpu.models", "flax.linen"]
    assert run.forbidden_modules(loaded) == ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
                                             "multimodaltopicsegmentation_tpu.models"]
    assert run.forbidden_modules(["multimodaltopicsegmentation_torch.models.base"]) == []


def _imported_top_levels(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_source_of_the_benchmark_imports_jax():
    sources = []
    for base, _, files in os.walk(HERE):
        sources += [os.path.join(base, f) for f in files
                    if f.endswith(".py") and not f.startswith("test_")]
    assert sources
    for path in sources:
        bad = set(_imported_top_levels(path)) & set(run.FORBIDDEN)
        assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    for base, _, files in os.walk(os.path.join(HERE, "reference")):
        for f in files:
            if f.endswith(".py"):
                names = set(_imported_top_levels(os.path.join(base, f)))
                assert not names & {"multimodaltopicsegmentation_torch", "mtsbench", *run.FORBIDDEN}


def test_loading_the_harness_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import run\n"
            "from mtsbench import harness, spec, trace, roofline, traffic, weights\n"
            "from reference import models, train, taggers\n"
            "import multimodaltopicsegmentation_torch.cli.predict, "
            "multimodaltopicsegmentation_torch.train.loop\n"
            "b = spec.load_benchmark(%r)\n"
            "[spec.metric_reader(m['name']) for m in b['per_layer'] + b['end_to_end']\n"
            " if m['name'] != 'setup_s']\n"
            "for w in b['workloads']:\n"
            "    c = spec.load_cell(w['name'], %r)\n"
            "    spec.driver(c.traffic['kind'])\n"
            "    spec.architecture(c.config['tagger']['architecture'])\n"
            "    taggers.load(c.config['tagger']['architecture'])\n"
            "print(run.forbidden_modules(sys.modules))\n") % (HERE, ROOT, ROOT, ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", BENCH["workloads"][0]["name"], "--seed", "2147483651",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
