"""What one launch through the port's launch function costs the host, in
three forms, on one CUDA card:

- "context + Stream": a `torch.cuda.device` context, `torch.cuda.
  current_stream(device).cuda_stream` and the library call (the earlier form);
- "raw stream, device checked" (committed, `cuda_kernels._launch`): the raw
  stream handle from `torch._C._cuda_getCurrentRawStream`, the device context
  only for a tensor on another card than the current one;
- "bare": the library call with a stream handle read once, the least a
  ctypes launch can cost.

Each form launches the library's empty kernel 20,000 times on an idle stream
(host clock over the loop, microseconds a launch) and once between CUDA events
as `chip_smoke.time_ms` times every kernel (the launch floor); then the
filter kernel at 640x480 the same way. The forms run in turns, three rounds.

    python3 dev/torch_probe_launch_path.py      # from the repo's root; needs nvcc and a card
"""

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


def launch_with_context(name, fn_name, device, *args):
    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn_name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {err}")
    if name is not None:
        ck.launches[name] += 1


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    lib = _build.load()
    raw = torch._C._cuda_getCurrentRawStream(0)
    st, x, valid = cs.filter_inputs(np.random.default_rng(0), dev, cs.H, cs.W)
    ref = ck.depth_filter_update(st, x, 0.013, valid)
    committed = ck._launch

    def bare(name, fn_name, device, *args):
        getattr(lib, fn_name)(*args, raw)

    forms = {"context + Stream": launch_with_context,
             "raw stream, device checked (committed)": committed, "bare": bare}
    for round_ in range(3):
        for name, form in forms.items():
            ck._launch = form
            try:
                out = ck.depth_filter_update(st, x, 0.013, valid)
                assert all(torch.equal(a, b) for a, b in zip(out, ref)), name
                host = cs.host_us_per_launch(lambda: ck.empty_launch(dev))
                floor = cs.time_ms(lambda: ck.empty_launch(dev), 20)
                host_f = cs.host_us_per_launch(
                    lambda: ck.depth_filter_update(st, x, 0.013, valid), 5000)
                alone = cs.time_ms(lambda: ck.depth_filter_update(st, x, 0.013, valid), 20)
            finally:
                ck._launch = committed
            print(f"round {round_} {name}: empty kernel host {host:.2f} us a launch, between "
                  f"events {floor:.4f} ms; filter wrapper host {host_f:.2f} us a call, between "
                  f"events {alone:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
