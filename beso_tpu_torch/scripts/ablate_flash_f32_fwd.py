"""Where the f32 width-64 flash forward's time goes, on one card.

    python3 beso_tpu_torch/scripts/ablate_flash_f32_fwd.py [--turns 3] \
        [--out build/ablate_flash_f32_fwd.json]

It copies `beso_tpu_torch/csrc/` to `build/ablate_flash_f32_fwd/` and guards
parts of `flash_fwd_f32_kernel` (csrc/flash_attention_f32.cu) there by a
`PROBE` macro; the checkout's sources stay as they are. Each variant switches
one part off:

0. nothing (the kernel as built);
1. the products and the softmax (`fwd_step`);
2. the K/V copies and the waits for them (the splits and products run on
   whatever the stages hold);
3. the in-place hi/lo split of the K/V tiles;
4. all of the above: what is left is the block's start, Q's copy and split,
   and the store of o and lse.

The three flash sources are compiled per variant (all `nvcc` processes at
once) into a library of its own, and `beso_flash_fwd` is timed at the chunked
shape [256, 6, 131, 60] f32, causal and full, with CUDA events over 50
launches after warm-up, the variants in turns. Only variant 0 computes
attention: it is held against the plain forward within 2^-12 of max |ref|.
It prints the card's name and power limit and one line per variant and turn,
and writes all of it as JSON to `--out`. It needs a CUDA card and `nvcc`,
and imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SHAPE = (256, 6, 131, 60)
SOURCES = ("flash_attention.cu", "flash_attention_f32.cu", "flash_attention_wide.cu")
VARIANTS = {0: "as built", 1: "no products", 2: "no K/V copies", 3: "no K/V split",
            4: "Q, block start and store only"}
# (line of the forward kernel, its guarded form); PROBE 4 switches all off
GUARDS = (
    ("    if (kt < nkt)\n      load_tiles<2, kTma>",
     "    if (kt < nkt && PROBE != 2 && PROBE != 4)\n      load_tiles<2, kTma>"),
    ("      hopper::mbar_wait(&full[kt % FWD_STAGES], (kt / FWD_STAGES) & 1);",
     "      if (PROBE != 2 && PROBE != 4)\n"
     "        hopper::mbar_wait(&full[kt % FWD_STAGES], (kt / FWD_STAGES) & 1);"),
    ("    split_tiles<2>(st, hdp, t);",
     "    if (PROBE != 3 && PROBE != 4) split_tiles<2>(st, hdp, t);"),
    ("    fwd_step<HDP, 2, false>(", "    if (PROBE != 1 && PROBE != 4) fwd_step<HDP, 2, false>("),
)


def guarded_sources(dst: Path) -> None:
    """csrc/ copied to dst with the forward kernel's parts guarded."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "beso_tpu_torch" / "csrc", dst)
    f = dst / "flash_attention_f32.cu"
    src = f.read_text()
    a, b = src.index("flash_fwd_f32_kernel("), src.index("// The dQ kernel")
    kernel = src[a:b]
    for old, new in GUARDS:
        if kernel.count(old) != 1:
            sys.exit(f"ablate_flash_f32_fwd: the forward kernel has no single {old.strip()!r}")
        kernel = kernel.replace(old, new)
    f.write_text(src[:a] + kernel + src[b:])


def build_variants(work: Path) -> dict:
    """{variant: loaded library} of the guarded sources at each PROBE."""
    from beso_tpu_torch.ops.build import _NVCC_FLAGS, find_nvcc

    nvcc, flags = find_nvcc(), [f for f in _NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {(v, s): subprocess.Popen(
        [nvcc, *flags, f"-DPROBE={v}", "-c", "-o", str(work / f"v{v}_{s}.o"),
         str(work / "csrc" / s)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for v in VARIANTS for s in SOURCES}
    for key, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            sys.exit(f"ablate_flash_f32_fwd: nvcc failed on {key}:\n{log}")
    libs = {}
    for v in VARIANTS:
        so = work / f"libablate_v{v}.so"
        subprocess.run([nvcc, *flags[:2], "-shared", "-o", str(so),
                        *(str(work / f"v{v}_{s}.o") for s in SOURCES)], check=True)
        lib = ctypes.CDLL(str(so))
        lib.beso_flash_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        libs[v] = lib
    return libs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--out", default="build/ablate_flash_f32_fwd.json")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from beso_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        sys.exit("ablate_flash_f32_fwd: no CUDA card: the variants are timed on one")
    torch.backends.cuda.matmul.allow_tf32 = False
    work = ROOT / "build" / "ablate_flash_f32_fwd"
    guarded_sources(work / "csrc")
    libs = build_variants(work)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not measured"
    print(f"card: {card}")

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(*SHAPE, generator=gen).to(dev) for _ in range(3))
    o, lse = torch.empty_like(q), torch.empty(*SHAPE[:3], 1, device=dev)
    B, H, T, hd = SHAPE

    def launch(lib, causal):
        rc = lib.beso_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                lse.data_ptr(), B * H, T, hd, int(causal), 1,
                                torch.cuda.current_stream().cuda_stream)
        if rc:
            sys.exit(f"ablate_flash_f32_fwd: launch failed ({rc})")

    def time_ms(lib, causal, n=50):
        for _ in range(5):
            launch(lib, causal)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(n):
            launch(lib, causal)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    for causal in (True, False):
        launch(libs[0], causal)
        o_ref, lse_ref = fa.flash_forward_reference(q, k, v, causal)
        for what, got, ref in (("o", o, o_ref), ("lse", lse, lse_ref)):
            err = (got - ref).abs().max().item()
            if not err <= 2.0 ** -12 * ref.abs().max().item():
                sys.exit(f"ablate_flash_f32_fwd: variant 0 {what} (causal={causal}) is off by "
                         f"{err}")
    times = {f"{i} {name}": {"causal": [], "full": []} for i, name in VARIANTS.items()}
    for turn in range(args.turns):
        for i, name in VARIANTS.items():
            row = times[f"{i} {name}"]
            row["causal"].append(time_ms(libs[i], True))
            row["full"].append(time_ms(libs[i], False))
            print(f"  turn {turn}, variant {i} ({name}): causal {row['causal'][-1]:.4f} ms, "
                  f"full {row['full'][-1]:.4f} ms")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": card, "shape": SHAPE, "ms": times}, indent=1))


if __name__ == "__main__":
    main()
