"""The Hopper instructions one threefry-2x32 draw takes, by pipe.

    python3 scripts/threefry_sass.py [--out FILE]

Compiles ``threefry.cu`` (``src/repro_torch/kernels/threefry/csrc``) for
sm_90a with the port's flags into a cubin, together with four probe
kernels that include its hash: ``probe_hash`` writes ``threefry_bits``'s
32-bit draw (the counter's two words hashed under a key, then ``x0 ^
x1``) and ``probe_none`` writes the counter's ``x0 ^ x1`` unhashed, with
the same loads, stores and index arithmetic. ``cuobjdump -sass`` lists
each kernel's instructions; their difference is one draw's hash. The
classes are the pipes that issue them: the ALU pipe (``IADD3``, ``LOP3``,
``SHF``, compares and selects), the FMA pipe (``IMAD`` forms), the
uniform datapath (``U*``: per key, once a warp, not a draw) and the rest
(memory, control). It also counts the opcodes of the library's own
kernels. Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit), not a card;
prints one JSON line and writes it to ``--out`` if given.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
SOURCE = HERE / "src/repro_torch/kernels/threefry/csrc/threefry.cu"

PROBES = r"""
#include "{source}"

__global__ void probe_hash(const unsigned long long* __restrict__ c,
                           uint32_t k0, uint32_t k1,
                           uint32_t* __restrict__ out) {{
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t x0 = static_cast<uint32_t>(c[i] >> 32);
  uint32_t x1 = static_cast<uint32_t>(c[i]);
  threefry2x32(k0, k1, x0, x1);
  out[i] = x0 ^ x1;
}}

__global__ void probe_none(const unsigned long long* __restrict__ c,
                           uint32_t k0, uint32_t k1,
                           uint32_t* __restrict__ out) {{
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t x0 = static_cast<uint32_t>(c[i] >> 32) + (k0 & 0u);
  uint32_t x1 = static_cast<uint32_t>(c[i]) + (k1 & 0u);
  out[i] = x0 ^ x1;
}}

__global__ void probe_draw(const uint32_t* __restrict__ c, uint32_t k0,
                           uint32_t k1, uint32_t* __restrict__ out) {{
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = draw(k0, k1, c[i]);
}}

__global__ void probe_draw_none(const uint32_t* __restrict__ c, uint32_t k0,
                                uint32_t k1, uint32_t* __restrict__ out) {{
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = c[i] + (k0 & 0u) + (k1 & 0u);
}}
"""

FMA_PIPE = ("IMAD", "IMUL", "FFMA", "FADD", "FMUL", "IDP")
ALU_PIPE = ("IADD3", "LOP3", "SHF", "ISETP", "SEL", "PRMT", "LEA", "IABS",
            "IMNMX", "FLO", "POPC", "BREV", "FSETP", "ICMP", "FSEL", "P2R",
            "R2P", "PLOP3", "IADD")
INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T\d]+\s+)?"
                   r"([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)")
FUNCTION = re.compile(r"Function : (\S+)")


def tool(name: str) -> str:
    for base in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if base and os.access(os.path.join(base, "bin", name), os.X_OK):
            return os.path.join(base, "bin", name)
    raise RuntimeError(f"{name} not found (set CUDA_HOME)")


def pipe(op: str) -> str:
    if op.startswith("U") and op not in ("UNKNOWN",):
        return "uniform"
    if op.startswith(FMA_PIPE):
        return "fma"
    if op in ALU_PIPE:
        return "alu"
    return "other"


def disassemble(cubin: Path) -> dict[str, collections.Counter]:
    out = subprocess.run([tool("cuobjdump"), "-sass", str(cubin)],
                         capture_output=True, text=True, check=True).stdout
    kernels, name = {}, None
    for line in out.splitlines():
        m = FUNCTION.search(line)
        if m:
            name = m.group(1)
            kernels[name] = collections.Counter()
            continue
        m = INSTR.search(line)
        if name and m and m.group(1) != "NOP":
            kernels[name][m.group(1) + m.group(2)] += 1
    return kernels


def by_pipe(ops: collections.Counter) -> dict[str, int]:
    out = collections.Counter()
    for op, n in ops.items():
        out[pipe(op.split(".")[0])] += n
    return dict(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.kernels import _build

    with tempfile.TemporaryDirectory() as tmp:
        probe = Path(tmp) / "probe.cu"
        probe.write_text(PROBES.format(source=SOURCE))
        cubin = Path(tmp) / "probe.cubin"
        subprocess.run([tool("nvcc"), *_build.BASE_FLAGS, "-cubin", "-o",
                        str(cubin), str(probe)], check=True)
        kernels = disassemble(cubin)

    def find(short):
        return next(v for k, v in kernels.items() if short in k)

    def per_draw(hashed, none):
        diff = collections.Counter(hashed)
        diff.subtract(none)
        pipes = {p: by_pipe(hashed).get(p, 0) - by_pipe(none).get(p, 0)
                 for p in ("alu", "fma", "uniform", "other")}
        return {"alu_fma": pipes["alu"] + pipes["fma"], "by_pipe": pipes,
                "by_opcode": {op: n for op, n in sorted(diff.items()) if n}}

    probes = {p: find(f"{p}P") for p in ("probe_hash", "probe_none",
                                         "probe_draw", "probe_draw_none")}
    result = {
        "source": str(SOURCE.relative_to(HERE)),
        "flags": " ".join(_build.BASE_FLAGS),
        "bits_hash_per_draw": per_draw(probes["probe_hash"],
                                       probes["probe_none"]),
        "draw_hash_per_draw": per_draw(probes["probe_draw"],
                                       probes["probe_draw_none"]),
        "probes": {k: dict(sorted(v.items())) for k, v in probes.items()},
        "kernels": {k: {"by_pipe": by_pipe(v), "total": sum(v.values())}
                    for k, v in kernels.items()
                    if not re.search(r"probe_(hash|none|draw)", k)},
    }
    line = json.dumps(result)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
