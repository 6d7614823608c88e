"""The card's float32-to-bf16 conversion rate, by a timed loop
(`csrc/cvt_rate.cu`): conversions a clock an SM, counted in instructions
and in values, for the packed form (`cvt.rn.bf16x2.f32`, one F2FP for two
values) and the scalar one (`cvt.rn.bf16.f32`, one value).

The bounds of the direct sums that round to bf16 ("bf16", "fast", "mxu";
`chip_smoke.py`) count the values each formulation converts a pair, at the
packed form's value rate that this measures; whether an F2FP that packs two
values costs one slot or two is what it settles.

    python -m nbx_torch.bench.cvt_rate [iters]

One block of 1,024 threads an SM, 8 chains of `iters` conversions a thread
(default 20,000). Each SM's rate is its blocks' conversions over its span
of clock64 clocks; the line gives the median, the least and the most over
the SMs, the whole launch's time by CUDA events and the clock that implies,
and the opcodes of the loop's SASS (`bench.sass`).
Prints one JSON line a form. Needs a card.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import sys

import torch

from nbx_torch.bench import sass, timing
from nbx_torch.ops import _build

THREADS, CHAINS = 1024, 8  # csrc/cvt_rate.cu
FORMS = {"bf16x2": (1, 2), "bf16": (0, 1)}  # form: (the entry's packed flag, values an instruction)


def _entry():
    fn = _build.load("cvt_rate").nbx_cvt_rate
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def loop_opcodes() -> dict[str, dict[str, float]]:
    """Each loop function's opcodes in its innermost loop body, by form."""
    found = sass.functions(_build.build("cvt_rate"))
    return {form: sass.per_pair(code)[1] for form, (flag, _) in FORMS.items()
            for fn, code in found.items() if f"cvt_loop<(bool){flag}>" in fn}  # cu++filt's name of cvt_loop<bool>


def measure(form: str, iters: int, device: torch.device) -> dict:
    """One launch of the loop in `form` (a warm-up first): its rates."""
    flag, per_instr = FORMS[form]
    blocks = torch.cuda.get_device_properties(device).multi_processor_count
    sink = torch.empty(blocks * THREADS, dtype=torch.int32, device=device)
    start, stop = (torch.empty(blocks, dtype=torch.int64, device=device) for _ in range(2))
    sm = torch.empty(blocks, dtype=torch.int32, device=device)
    fn = _entry()

    def launch():
        with torch.cuda.device(device):
            err = fn(flag, sink.data_ptr(), start.data_ptr(), stop.data_ptr(), sm.data_ptr(), blocks, iters,
                     torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"nbx_cvt_rate launch failed: cudaError_t {err}")
    launch()
    t0 = timing.stamp(device)
    launch()
    ms = timing.elapsed_ms(t0, timing.stamp(device))
    per_block = THREADS * CHAINS * iters
    spans: dict[int, list] = {}
    for s, a, b in zip(sm.tolist(), start.tolist(), stop.tolist()):
        spans.setdefault(s, []).append((a, b))
    rates = [len(v) * per_block / (max(b for _, b in v) - min(a for a, _ in v)) for v in spans.values()]
    instr = statistics.median(rates)
    clocks = statistics.median(max(b for _, b in v) - min(a for a, _ in v) for v in spans.values())
    return dict(form=form, instructions_a_clock_an_sm=instr, values_a_clock_an_sm=instr * per_instr,
                least=min(rates) * per_instr, most=max(rates) * per_instr, sms=len(spans), blocks=blocks,
                iters=iters, ms=ms, implied_ghz=clocks / (ms * 1e6),
                values_per_s=blocks * per_block * per_instr / (ms * 1e-3), device=timing.device_name(device))


def main(iters: int = 20_000) -> list[dict]:
    device = timing.require("cuda")
    ops = loop_opcodes()
    rows = []
    for form in FORMS:
        rows.append(dict(measure(form, iters, device), loop_opcodes=ops.get(form)))
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:2]))
