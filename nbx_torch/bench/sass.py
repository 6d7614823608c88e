"""Instructions per pair of the pair kernels, read from their SASS.

Builds the kernels (`ops/_build.py`), disassembles each library with
`cuobjdump -sass` and, for every kernel function, finds its innermost pair
loop (the shortest span that ends in a backward branch and holds a
MUFU.RSQ; a kernel may have shorter loops that stage its tiles). The loop
body holds a whole number of pairs, one MUFU.RSQ (rsqrtf) each, so the
opcode counts in the body over its MUFU.RSQ count are the instructions a
pair: thread instructions, as the schedulers issue them. The P3M kernels
K5 (pp_react) and K4 (pp_short) count the same way, their law's other
special functions (MUFU.EX2, MUFU.RCP) beside it. "mxu"'s and "fast"'s loop bodies
are a warp's 16-source chunks, 8 pairs a lane each, and 2 MMAs (HMMA) a
chunk, each one instruction a lane for the warp's 256 pairs: 1/4 of an HMMA
a pair. A loop without MUFU.RSQ (the split sums' combine) is counted once
(pairs_in_loop 0). K1's symmetric sum (pairwise_f32r_kernel_sym) has two
pair loops, its diagonal's one-sided loop and the rotation loop that
evaluates the rest: it is counted by the shortest loop that holds a
MUFU.RSQ and a SHFL, whose MUFU.RSQ are unordered pairs. K1's rows also give
instructions_an_unordered_pair (the one-sided kernel's, twice its ordered
pair's). Prints one
JSON line per kernel function: its name, the pairs in the loop body, and the
instructions a pair by opcode (modifiers dropped after the first, as in
F2FP.BF16).

The collision kernel (collide_fused: K2, K2m, K8 and the probes, and K7
with kGrav) has no MUFU.RSQ a lane: its overlap test runs in a loop of its
own, several lanes unrolled, apart from the hit path (rsqrtf and the
physics, taken only by overlapping pairs, in a loop over the hits). Its
marker is the shortest loop that holds at least 4 LDS.128 (K7's: the
shortest that holds a MUFU.EX2, its law on every lane): each lane of K2's
overlap test loads its staged row's first 16 bytes (x y z vx) once, so the
LDS.128 in that loop are its lanes; K7's loop evaluates the law once a lane
a target, so its lanes are its MUFU.EX2 over R (ptxas may add an LDS.128
there: K7's one-MUFU law's loop holds 5 for 4 lanes); the hit loop loads
whole rows, two a hit, and evaluates no exponential. It reports
instructions a lane (lanes_in_loop) and, over its R targets a thread (the
kernel's first template argument), a pair.

    python -m nbx_torch.bench.sass [kernel ...]
    # default: the direct sums; or pp_react pp_short collide_fused

Needs nvcc and cuobjdump (the CUDA toolkit), not a card.
"""

from __future__ import annotations

import collections
import json
import re
import subprocess
import sys
from pathlib import Path

from nbx_torch.ops import _build

SYMMETRIC = "pairwise_f32r_kernel_sym"
DIRECT_SUMS = ("pairwise_f32r", "pairwise_precision", "pairwise_fast", "pairwise_mxu", "pairwise_accjerk",
               "potential")
_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def _tool(name: str) -> str:
    return str(Path(_build.nvcc_path()).with_name(name))


def functions(lib: Path) -> dict[str, list[tuple[int, str, str]]]:
    """Each kernel function's instructions, (address, opcode, operands), by
    demangled name; a branch target written as a label becomes the address
    of the instruction after the label."""
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    out, labels = {}, {}
    for line in sass.splitlines():
        if "Function :" in line:
            code, labels[code_id := len(out)], pending = [], {}, []
            out[line.split("Function :", 1)[1].strip()] = code
        elif out and (m := re.match(r"\s*(\.L\w+):", line)):
            pending.append(m.group(1))
        elif out and (m := _LINE.search(line)):
            code.append((int(m.group(1), 16), m.group(2), m.group(3)))
            labels[code_id].update((label, code[-1][0]) for label in pending)
            pending = []
    for code_id, code in enumerate(out.values()):
        code[:] = [(a, op, re.sub(r"`\((\.L\w+)\)", lambda m: hex(labels[code_id].get(m.group(1), 0)), args))
                   for a, op, args in code]
    names = subprocess.run([_tool("cu++filt")], input="\n".join(out), capture_output=True, text=True,
                           check=True).stdout.splitlines()
    return dict(zip(names, out.values()))


def _body(code, lo: int, hi: int) -> collections.Counter:
    return collections.Counter(".".join(op.split(".")[:2]) for addr, op, _ in code if lo <= addr <= hi)


def _loops(code):
    """Every loop: (first address, backward branch's address, body counts)."""
    out = []
    for addr, op, args in code:
        target = re.search(r"0x([0-9a-f]+)", args)
        if op.startswith("BRA") and target and int(target.group(1), 16) < addr:
            lo = int(target.group(1), 16)
            out.append((lo, addr, _body(code, lo, addr)))
    return out


def per_pair(code: list[tuple[int, str, str]], rotation: bool = False) -> tuple[int, dict[str, float]]:
    """(pairs in the innermost loop body, instructions a pair by opcode): the
    shortest loop that holds a MUFU.RSQ (and, for `rotation`, a SHFL), else
    the shortest loop."""
    loops = [loop for loop in _loops(code) if not rotation or any(op.startswith("SHFL") for op in loop[2])]
    if not loops:
        return 0, {}
    _, _, body = min(loops, key=lambda loop: (loop[2].get("MUFU.RSQ", 0) == 0, loop[1] - loop[0]))
    pairs = body.get("MUFU.RSQ", 0)
    return pairs, {op: n / max(pairs, 1) for op, n in sorted(body.items())}


def per_lane(code: list[tuple[int, str, str]], targets: int = 1) -> tuple[int, dict[str, float]]:
    """(lanes in the overlap loop, instructions a lane by opcode) of a
    collision kernel of `targets` targets a thread: the shortest loop that
    holds a MUFU.EX2 (K7: a lane an EX2 a target), or else the shortest that
    holds at least 4 LDS.128, one a lane, counted whole (no branch in it)."""
    loops = [(hi - lo, body) for lo, hi, body in _loops(code)
             if body.get("LDS.128", 0) >= 1 and (body.get("MUFU.EX2", 0) or body["LDS.128"] >= 4)]
    if not loops:
        return 0, {}
    _, body = min(loops, key=lambda loop: (loop[1].get("MUFU.EX2", 0) == 0, loop[0]))
    lanes = body["MUFU.EX2"] // targets if body.get("MUFU.EX2", 0) else body["LDS.128"]
    return lanes, {op: n / lanes for op, n in sorted(body.items())}


def targets_a_thread(fn: str) -> int:
    """The first template argument of a collision kernel's name (R),
    demangled or not."""
    return int(re.search(r"(?:<|ILi)(?:\(int\))?(\d+)", fn).group(1))


def main(kernels=DIRECT_SUMS) -> list[dict]:
    rows = []
    for lib, name in zip(_build.build_all(kernels), kernels):
        for fn, code in functions(lib).items():
            if name == "collide_fused":
                if "collide_fused_kernel" not in fn:
                    continue
                r = targets_a_thread(fn)
                lanes, ops = per_lane(code, r)
                a_lane = sum(ops.values())
                rows.append({"source": f"csrc/{name}.cu", "function": fn, "lanes_in_loop": lanes,
                             "targets_a_thread": r, "instructions_a_lane": a_lane,
                             "instructions_a_pair": a_lane / r, "by_opcode": ops})
                print(json.dumps(rows[-1]), flush=True)
                continue
            pairs, ops = per_pair(code, SYMMETRIC in fn)
            rows.append({"source": f"csrc/{name}.cu", "function": fn, "pairs_in_loop": pairs,
                         "instructions_a_pair": sum(ops.values()), "by_opcode": ops})
            if name == "pairwise_f32r" and pairs:
                rows[-1]["instructions_an_unordered_pair"] = sum(ops.values()) * (1 if SYMMETRIC in fn else 2)
            print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main(tuple(sys.argv[1:]) or DIRECT_SUMS)
