"""Times variants of the port's WTA kernel (``cvids_tpu_torch/csrc/wta.cu``)
against the committed design on one CUDA card: vectors per lane (1, 2, 4),
threads per block (128, 256, 512) and the flavour of the loads (streaming
`__ldcs`, `__ldg`, plain).

Each variant is a patched copy of ``csrc/`` under ``build/variants/<name>/``,
built by `_build` as the package builds its own. Every variant is first held
to the twin (exact) on two and four bf16 parts and two fp32 parts at
640x480x128, then timed between CUDA events: two bf16 parts as the dense
path calls it (median of 20), the same after a 256 MB write that empties the
L2 (median of 10), four bf16 parts and two fp32 parts (median of 10). The
variants run in two rounds, so each is timed twice in one process.

    python3 dev/torch_probe_wta_variants.py      # from the repo's root; needs nvcc and a card
"""

import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from cvids_tpu_torch import _build  # noqa: E402
from cvids_tpu_torch.ops import cuda_kernels as ck  # noqa: E402

VECTORS, THREADS, LOAD = "WTA_MAX_VECTORS = 2;", "WTA_THREADS = 256;", "__ldcs(row + j * G)"
VARIANTS = {
    "2 vectors, 256 threads, __ldcs (committed)": [],
    "1 vector": [(VECTORS, "WTA_MAX_VECTORS = 1;")],
    "4 vectors": [(VECTORS, "WTA_MAX_VECTORS = 4;")],
    "128 threads": [(THREADS, "WTA_THREADS = 128;")],
    "512 threads": [(THREADS, "WTA_THREADS = 512;")],
    "__ldg": [(LOAD, "__ldg(row + j * G)")],
    "plain loads": [(LOAD, "row[j * G]")],
    "4 vectors, 128 threads": [(VECTORS, "WTA_MAX_VECTORS = 4;"),
                               (THREADS, "WTA_THREADS = 128;")],
}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    h, w, d = cs.H, cs.W, cs.D

    def volume():
        return torch.from_numpy(rng.uniform(0, 50, (h, w, d)).astype(np.float32)).to(dev)

    fa, fb = volume(), volume()
    pa, pb = fa.to(torch.bfloat16), fb.to(torch.bfloat16)
    calls = {"2 x bf16": (pa, pb), "4 x bf16": (pa, pb, pa.roll(1, 2), pb.roll(2, 2)),
             "2 x fp32": (pa.float(), pb.float())}
    refs = {k: ck.wta_twin(*v) for k, v in calls.items()}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    for _ in range(2):
        for k, (name, patches) in enumerate(VARIANTS.items()):
            vdir = ROOT / "build" / "variants" / str(k)
            if not vdir.exists():
                shutil.copytree(_build._PKG / "csrc", vdir / "csrc")
                text = (vdir / "csrc" / "wta.cu").read_text()
                for old, new in patches:
                    if text.count(old) != 1:
                        raise RuntimeError(f"{name}: {old!r} is not in wta.cu exactly once")
                    text = text.replace(old, new)
                (vdir / "csrc" / "wta.cu").write_text(text)
            _build.CSRC, _build.BUILD_DIR, _build._lib = vdir / "csrc", vdir / "cuda", None
            for key, parts in calls.items():
                out = ck.wta(*parts)
                if not (torch.equal(out[0], refs[key][0]) and torch.equal(out[1], refs[key][1])):
                    raise AssertionError(f"{name}: {key} differs from the twin")
            warm = cs.time_ms(lambda: ck.wta(pa, pb), 20)
            cold = []
            for _ in range(10):
                flush.zero_()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                ck.wta(pa, pb)
                end.record()
                end.synchronize()
                cold.append(start.elapsed_time(end))
            four = cs.time_ms(lambda: ck.wta(*calls["4 x bf16"]), 10)
            fp32 = cs.time_ms(lambda: ck.wta(*calls["2 x fp32"]), 10)
            print(f"{name}: 2 x bf16 {warm:.4f} ms, after an L2 flush "
                  f"{statistics.median(cold):.4f} ms, 4 x bf16 {four:.4f} ms, 2 x fp32 "
                  f"{fp32:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
