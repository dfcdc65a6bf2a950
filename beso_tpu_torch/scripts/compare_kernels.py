"""Times the port's CUDA kernels in several checkouts in turn, on one card.

    python3 beso_tpu_torch/scripts/compare_kernels.py \
        --trees build/parent,.,.,build/parent,build/parent,. [--out build/compare_kernels.json]

Each tree is a checkout of this repository (a `git archive` of a commit
unpacked in a git-ignored directory, or `.`). The kernels of every tree
are built first, all trees in parallel, each into its own `build/kernels/`.
Then each entry of `--trees` runs in a process of its own, in the order
given (parent, change, change, parent, parent, change compares two
commits on one card within one call, each three times), and times with
`chip_smoke.py`'s own helpers of this checkout at its shapes, CUDA events
after warm-up:

- the flash kernels B5 / B6 (forward, dQ with delta, dK/dV, the backward
  total) at the chunked shape [256, 6, 131, 60], at [256, 3, 131, 128] and
  at the 3-head model's [256, 3, 131, 120], in bf16 and f32, beside
  `F.scaled_dot_product_attention`'s forward and backward there;
- B1 at the kitchen serving shape in bf16 and f32 and in f32 at the
  block-push shape, B2-B4 at the kitchen shape in bf16 and f32.

It prints one line per metric (the time of each turn, and the mean of the
turns of each tree over the mean of the first tree's), the card's name and
power limit, and writes all of it as JSON to `--out`. It needs a CUDA card
and `nvcc`, and imports no JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _chip_smoke():
    """This checkout's chip_smoke.py as a module (its timing helpers)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_tree(device, cs) -> dict:
    """{metric: ms} on `device` of the kernels of the `beso_tpu_torch` first
    on sys.path, with the helpers and shapes of `cs` (chip_smoke.py)."""
    import torch

    gen = torch.Generator().manual_seed(0)
    out = {}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for shape in (cs.CHUNKED_SHAPE, cs.WIDE_SHAPE, cs.WIDE_MODEL_SHAPE):
            where = f"{tag} {list(shape)}"
            for name, (ms, _) in cs.time_flash(device, gen, dtype, shape).items():
                out[f"{name} {where}"] = ms
            fwd, bwd, _ = cs.time_sdpa(device, gen, dtype, shape)
            out[f"sdpa forward {where}"], out[f"sdpa backward {where}"] = fwd, bwd
        rows = 2 * cs.N_ENVS
        out[f"fused_layer_prefix {tag} kitchen"] = cs.time_kernel(rows, device, gen, dtype)[0]
        for name, (ms, _) in cs.time_other_layers(rows, device, gen, dtype).items():
            out[f"{name} {tag} kitchen"] = ms
    out["fused_layer_prefix f32 block_push"] = cs.time_kernel(
        2 * cs.N_ENVS, device, gen, torch.float32, cs.BLOCK_PUSH_LAYER)[0]
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", help="checkouts to time, comma-separated, in turn")
    ap.add_argument("--out", default="build/compare_kernels.json")
    ap.add_argument("--one", help=argparse.SUPPRESS)   # a turn's process: this tree
    args = ap.parse_args(argv)
    if args.one:
        sys.path.insert(0, str(Path(args.one).resolve()))
        import torch

        cs = _chip_smoke()
        if not torch.cuda.is_available():
            cs.fail("no CUDA card: the kernels are timed on one")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(json.dumps(time_tree(torch.device("cuda", 0), cs)))
        return
    trees = [Path(t).resolve() for t in args.trees.split(",")]
    distinct = list(dict.fromkeys(trees))
    build = "from beso_tpu_torch.ops import build; build.build_kernels()"
    procs = [subprocess.Popen([sys.executable, "-c", build], cwd=t) for t in distinct]
    if any(p.wait() for p in procs):
        sys.exit("compare_kernels: a kernel build failed")
    turns = []
    for t in trees:
        res = subprocess.run([sys.executable, __file__, "--one", str(t)], capture_output=True,
                             text=True)
        if res.returncode:
            sys.exit(f"compare_kernels: the turn in {t} failed:\n{res.stdout}{res.stderr}")
        turns.append(json.loads(res.stdout.strip().splitlines()[-1]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not measured"
    names = [str(t.relative_to(ROOT)) if t.is_relative_to(ROOT) else str(t) for t in trees]
    print(f"card: {card}; turns: {', '.join(names)}")
    ratios = {}
    for metric in turns[0]:
        means = {n: sum(r[metric] for r, m in zip(turns, names) if m == n)
                 / names.count(n) for n in dict.fromkeys(names)}
        first = means[names[0]]
        ratios[metric] = {n: v / first for n, v in means.items()}
        print(f"  {metric}: " + " / ".join(f"{r[metric]:.4f}" for r in turns) + " ms; "
              + ", ".join(f"{n} {v:.3f}x" for n, v in ratios[metric].items()))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": card, "trees": names, "turns": turns,
                                          "ratio_to_first": ratios}, indent=1))


if __name__ == "__main__":
    main()
