"""No JAX module in a run, and none of the port in the reference: module
names compared by their whole top-level name."""

import re
import subprocess
import sys
from pathlib import Path

from h100_bench import harness

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def test_top_level_names_compared_whole(monkeypatch):
    mods = dict(sys.modules)
    for k in [k for k in mods if k.split(".")[0] in harness.FORBIDDEN]:
        mods.pop(k)
    mods.update({"lantern_tpu_torch.ops": None, "jaxtyping": None})
    monkeypatch.setattr(sys, "modules", mods)
    assert harness.forbidden_modules() == []
    mods.update({"jax.numpy": None, "lantern_tpu.trees": None})
    assert harness.forbidden_modules() == ["jax", "lantern_tpu"]


def _loaded_after(code: str):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split("
         "'.')[0] for m in sys.modules}))"], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return eval(out.stdout.strip().splitlines()[-1])


def test_reference_loads_no_port():
    tops = _loaded_after("import h100_bench.check, h100_bench.weights, "
                         "h100_bench.reference.model, "
                         "h100_bench.reference.families.chameleon, "
                         "h100_bench.reference.families.llamagen, "
                         "h100_bench.reference.captions, "
                         "h100_bench.reference.lantern")
    assert not {"lantern_tpu_torch", "lantern_tpu", "jax", "jaxlib",
                "flax"} & set(tops)


def test_harness_and_port_load_no_jax():
    tops = _loaded_after("import h100_bench.run, h100_bench.harness, "
                         "h100_bench.trace, h100_bench.capture, "
                         "h100_bench.faults, h100_bench.drivers.engine_window,"
                         " h100_bench.drivers.session_calls, "
                         "h100_bench.families.chameleon, "
                         "h100_bench.families.llamagen")
    assert "lantern_tpu_torch" in tops
    assert not {"lantern_tpu", "jax", "jaxlib", "flax"} & set(tops)


def test_sources_import_no_jax():
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|lantern_tpu)\b"
                     r"(?!_torch)", re.M)
    port = re.compile(r"lantern_tpu_torch")
    for p in BENCH.rglob("*.py"):
        src = p.read_text()
        assert not pat.search(src), p
        if "reference" in p.parts:
            assert not port.search(src), p
