#!/usr/bin/env python3
"""The card's rate of ``mma.sync.m16n8k8`` TF32, the instruction of the SSD
kernels' 3xTF32 products: a ceiling for kernels built on it, beside the
494.7 TFLOP/s TF32 peak of the H100's tensor cores (reached through
``wgmma``).

    python3 tools/mma_rate.py

Builds ``tools/mma_rate.cu`` with nvcc (into ``build/tools/``) and times,
with CUDA events, launches of 4 blocks per SM at 4, 8 and 16 warps a
block: plain MMAs on register operands, then the 3xTF32 form (operands
split into TF32 big and small parts each step, three passes). Prints one
JSON line per form and warp count: MMAs per clock per SM (at the SM clock
``nvidia-smi`` reads during the run), the TF32 FLOP/s they make, and that
rate's share of 494.7 TFLOP/s.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PEAK_TF32 = 494.7e12
STEPS = 4096


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.kernels.build import find_nvcc

    if not torch.cuda.is_available():
        print("mma_rate: no CUDA device", file=sys.stderr)
        return 1
    out_dir = ROOT / "build" / "tools"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libmma_rate.so"
    subprocess.run([find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib_path),
                    str(ROOT / "tools" / "mma_rate.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.repro_mma_rate.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.repro_mma_rate.restype = ctypes.c_int
    chains = lib.repro_mma_chains()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smi = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"]
    for split in (0, 1):
        for warps in (4, 8, 16):
            blocks, threads = 4 * sms, 32 * warps
            buf = torch.empty(blocks * threads, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream

            def launch():
                rc = lib.repro_mma_rate(buf.data_ptr(), blocks, threads, STEPS, split, stream)
                if rc:
                    raise RuntimeError(f"mma_rate: CUDA error {rc}")

            for _ in range(3):
                launch()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                launch()
            end.record()
            card = subprocess.run(smi, capture_output=True, text=True).stdout.strip()
            torch.cuda.synchronize()
            secs = start.elapsed_time(end) / 1e3 / 10
            mmas = blocks * warps * STEPS * chains * (3 if split else 1)
            mhz = float(card.split(",")[-1].split()[0])
            rate = mmas * 16 * 8 * 8 * 2 / secs
            print(json.dumps({"form": "3xtf32 split" if split else "plain", "warps_per_block": warps,
                              "blocks": blocks, "ms": secs * 1e3,
                              "mma_per_clock_per_sm": mmas / secs / (mhz * 1e6) / sms,
                              "tf32_flops": rate, "share_of_peak": rate / PEAK_TF32,
                              "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
