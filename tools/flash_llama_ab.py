"""Time the flash forward and bf16 backward at the Llama-3.2-1B shape from
the repro_torch of one or more checkouts, in turns, on one card.

    python tools/flash_llama_ab.py [ROOT ...]

Each ROOT (default: this checkout) runs in a process of its own, in the
order given, so that ``python tools/flash_llama_ab.py build/parent . .
build/parent`` times a parent checkout unpacked into build/parent and this
one in turns (parent, change, change, parent). The shape is the Llama
prefill's and training step's: B=2, S=2048, 32 query and 8 kv heads of 64,
causal, bf16, seq-major views, no window and no softcap, which the calls
of both trees express alike (``ops.flash_attention(q, k, v, True)``). A
ROOT builds its kernels into its own build/torch_kernels/. Each turn prints
one JSON line: the card, the root, and per kernel the device time of one
call (the median over a capture-checked profiler window of 10 calls,
``chip_smoke.device_us``) and the CUDA-event time per call (median of 5
runs of 50 calls, 10 for the backward).
"""
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def turn(root: str) -> dict:
    """One root's times, in this process (called in a child process)."""
    sys.path[:0] = [os.path.join(root, "src"), HERE]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(cs.SEED)
    q, k, v, do = (torch.randn(2, 2048, h, 64, generator=gen).to(
        dev, torch.bfloat16).transpose(1, 2) for h in (32, 8, 8, 32))
    o, lse = fa.flash_attention(q, k, v, True, with_lse=True)
    out = {"root": root, "src": fa.__file__}
    for name, fn, args, cnames, inner in (
            ("flash_attention", ops.flash_attention, (q, k, v, True),
             ("flash_tc_kernel",), 50),
            ("flash_attention_bwd", ops.flash_attention_bwd,
             (q, k, v, o, lse, do, True),
             ("flash_bwd_delta_tc", "flash_bwd_dkdv_tc", "flash_bwd_dq_tc"),
             10)):
        busy, _, capture = cs.device_us([(fn, args)] * 10, reps=1,
                                        expect={c: 10 for c in cnames})
        per = capture.get("per_call_us")
        out[name] = {
            "device_ms": None if busy is None or not per
            else sorted(per)[len(per) // 2] / 1e3,
            "event_ms": cs.median_ms(fn, *args, inner=inner)}
    return out


def main() -> None:
    roots = sys.argv[1:] or ["."]
    if roots[0] == "--turn":
        print(json.dumps(turn(os.path.abspath(roots[1]))))
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    for root in roots:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--turn", root], capture_output=True,
                             text=True)
        if res.returncode:
            sys.exit(f"{root}: exit {res.returncode}\n{res.stderr[-4000:]}")
        print(res.stdout.strip().splitlines()[-1])


if __name__ == "__main__":
    main()
