"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module name, and the reference loads nothing of the
program."""

import json
import subprocess
import sys

from benchmark import spec as spec_mod
from benchmark.run import FORBIDDEN, forbidden_modules

SPEC = spec_mod.load()

PROBE = """
import json, sys
from benchmark.tests import tiny
for name in {cells!r}:
    tiny.run(name, trace=True)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
import benchmark.reference.kitchen, benchmark.reference.model
import benchmark.reference.precision, benchmark.reference.sampling
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code: str) -> set:
    p = subprocess.run([sys.executable, "-c", code], cwd=SPEC.root, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_every_mix_runs_without_jax():
    """Each traffic mix's import path, run end to end at a tiny size."""
    cells, kinds = [], set()
    for w in SPEC.bench["workloads"]:
        kind = SPEC.traffic(w["traffic"])["kind"]
        if kind not in kinds:
            kinds.add(kind)
            cells.append(w["name"])
    loaded = _top_level(PROBE.format(cells=cells))
    assert "beso_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level(REFERENCE)
    assert not loaded & {"beso_tpu_torch", *FORBIDDEN}


def test_forbidden_names_are_compared_whole(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "beso_tpu_torch_probe", types.ModuleType("p"))
    monkeypatch.setitem(sys.modules, "jaxtyping_probe.sub", types.ModuleType("p"))
    assert not {"beso_tpu_torch_probe", "jaxtyping_probe"} & set(forbidden_modules())
    monkeypatch.setitem(sys.modules, "flax.probe", types.ModuleType("p"))
    assert "flax" in forbidden_modules()
