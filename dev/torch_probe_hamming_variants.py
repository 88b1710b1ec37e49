"""Times variants of the port's Hamming kernel (``cvids_tpu_torch/csrc/
hamming.cu``) and of its depth-filter kernel (``csrc/depth_filter.cu``)
against the committed designs on one CUDA card.

Hamming: the rows of `a` a block walks (4, committed; 8, 16, 32), 64 and 256
columns a block, streaming stores, and the earlier design (128 x 32 tile,
4-byte loads, eight `__popc`). Filter: one pixel a thread (committed), two
and four pixels a thread (`VECTOR_FILTER` below: a thread moves its pixels as
8- and 16-byte vectors, the last npix % pixels take one thread each), 64, 128
and 256 threads, plain loads and stores instead of streaming ones, and the
earlier design (one pixel a thread, 256 threads, plain accesses), each at
480 x 640 and at 1080 x 1920, where four pixels a thread still leave every SM
a full set of warps.

Each variant is a patched copy of ``csrc/`` under ``build/variants/<name>/``
(the earlier designs come from ``build/parent/``, an unpacked `git archive`
of the parent commit's package, with a stub plan function appended), built by
`_build` as the package builds its own. Every variant is first held to the
twin (Hamming exact at 160x512 masked, 2048x2048, 37x129; the filter within
2 ulp at 480x640, 1080x1920 and 37x53), then timed three ways: alone between
CUDA events (median of 20), under the profiler (the kernel's device time, median of 5
profiled calls) and back to back (200 launches between two events, per
launch). The variants run in two rounds, so each is timed twice in a process.

    git archive HEAD~1 cvids_tpu_torch | tar -x -C build/parent     # once
    python3 dev/torch_probe_hamming_variants.py    # from the repo's root; needs nvcc and a card
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

PARENT = ROOT / "build" / "parent" / "cvids_tpu_torch" / "csrc"
# the plan function that the earlier Hamming design's source lacks
STUBS = {"hamming.cu": 'extern "C" int cvids_hamming_plan(int, int, int*) { return 1; }\n'}
TN, TM = "TN = 4;", "TM = 128;"
STORE = "dst[static_cast<long>(r) * m] = (bv && sav[r]) ? d : 512;"
THREADS = "FILTER_THREADS = 256;"
PLAIN = [("__ldcs(", "*("), ("__stcs(", "plain_store(")]
KERNEL_START = "__global__ void __launch_bounds__(FILTER_THREADS)"


def vector_filter(pixels: int):
    """A patch that replaces the committed one-pixel kernel and its entry
    point by `VECTOR_FILTER` at `pixels` pixels a thread."""
    def patch(text: str) -> str:
        return text[:text.index(KERNEL_START)] + VECTOR_FILTER.replace("@PIXELS@", str(pixels))
    return patch


HAMMING = {
    "4 rows, 128 columns (committed)": [],
    "8 rows": [(TN, "TN = 8;")],
    "16 rows": [(TN, "TN = 16;")],
    "32 rows": [(TN, "TN = 32;")],
    "64 columns": [(TM, "TM = 64;")],
    "256 columns": [(TM, "TM = 256;")],
    "streaming stores": [(STORE, "__stcs(dst + static_cast<long>(r) * m, (bv && sav[r]) ? d : 512);")],
    "the earlier design": "hamming.cu",
}
FILTER = {
    "1 pixel a thread, 256 threads, streaming (committed)": [],
    "1 pixel, 128 threads": [(THREADS, "FILTER_THREADS = 128;")],
    "1 pixel, plain loads and stores": PLAIN,
    "2 pixels a thread": [vector_filter(2)],
    "2 pixels, 128 threads": [vector_filter(2), (THREADS, "FILTER_THREADS = 128;")],
    "4 pixels a thread": [vector_filter(4)],
    "4 pixels, 128 threads": [vector_filter(4), (THREADS, "FILTER_THREADS = 128;")],
    "4 pixels, 64 threads": [vector_filter(4), (THREADS, "FILTER_THREADS = 64;")],
    "4 pixels, 128 threads, plain loads and stores": [
        vector_filter(4), (THREADS, "FILTER_THREADS = 128;"), *PLAIN],
    "the earlier design": "depth_filter.cu",
}
# The filter with two or four pixels a thread: it takes the place of the
# committed file from its kernel to its end, and uses that file's
# filter_pixel. Whole tensors only (every map starts a 16-byte vector).
VECTOR_FILTER = """constexpr int FILTER_PIXELS = @PIXELS@;    // pixels a thread owns: 2 or 4

struct FilterArgs {
  const float *mu, *s2, *a, *b, *x, *tau2;
  const uint8_t* valid;
  float tau2_value, mu_lo, mu_hi, uniform;
  float *mu_out, *s2_out, *a_out, *b_out;
  long npix;
  long nvec;   // pixels [0, PX nvec) move as vectors, the rest one by one
};

// PX neighbouring fp32 values and validity bytes as one aligned vector
template <int PX> struct alignas(4 * PX) FloatVec { float v[PX]; };
template <int PX> struct alignas(PX) ByteVec { uint8_t v[PX]; };

template <int PX>
__device__ __forceinline__ FloatVec<PX> load_stream(const float* p, long t);
template <>
__device__ __forceinline__ FloatVec<4> load_stream<4>(const float* p, long t) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p) + t);
  return {{q.x, q.y, q.z, q.w}};
}
template <>
__device__ __forceinline__ FloatVec<2> load_stream<2>(const float* p, long t) {
  const float2 q = __ldcs(reinterpret_cast<const float2*>(p) + t);
  return {{q.x, q.y}};
}

template <int PX>
__device__ __forceinline__ ByteVec<PX> load_stream(const uint8_t* p, long t);
template <>
__device__ __forceinline__ ByteVec<4> load_stream<4>(const uint8_t* p, long t) {
  const uchar4 q = __ldcs(reinterpret_cast<const uchar4*>(p) + t);
  return {{q.x, q.y, q.z, q.w}};
}
template <>
__device__ __forceinline__ ByteVec<2> load_stream<2>(const uint8_t* p, long t) {
  const uchar2 q = __ldcs(reinterpret_cast<const uchar2*>(p) + t);
  return {{q.x, q.y}};
}

__device__ __forceinline__ void store_stream(float* p, long t, const FloatVec<4>& o) {
  __stcs(reinterpret_cast<float4*>(p) + t, make_float4(o.v[0], o.v[1], o.v[2], o.v[3]));
}
__device__ __forceinline__ void store_stream(float* p, long t, const FloatVec<2>& o) {
  __stcs(reinterpret_cast<float2*>(p) + t, make_float2(o.v[0], o.v[1]));
}

__device__ __forceinline__ void filter_scalar(const FilterArgs& p, long i) {
  const float tau2 = p.tau2 != nullptr ? p.tau2[i] : p.tau2_value;
  const FilterOut o = filter_pixel(p.mu[i], p.s2[i], p.a[i], p.b[i], p.x[i], tau2,
                                   p.valid[i] != 0, p.mu_lo, p.mu_hi, p.uniform);
  p.mu_out[i] = o.mu;
  p.s2_out[i] = o.s2;
  p.a_out[i] = o.a;
  p.b_out[i] = o.b;
}

template <int PX>
__global__ void __launch_bounds__(FILTER_THREADS)
depth_filter_kernel(const FilterArgs p) {
  const long t = static_cast<long>(blockIdx.x) * FILTER_THREADS + threadIdx.x;
  if (t >= p.nvec) {
    const long i = PX * p.nvec + (t - p.nvec);
    if (i < p.npix) filter_scalar(p, i);
    return;
  }
  const FloatVec<PX> mu = load_stream<PX>(p.mu, t);
  const FloatVec<PX> s2 = load_stream<PX>(p.s2, t);
  const FloatVec<PX> a = load_stream<PX>(p.a, t);
  const FloatVec<PX> b = load_stream<PX>(p.b, t);
  const FloatVec<PX> x = load_stream<PX>(p.x, t);
  const ByteVec<PX> v = load_stream<PX>(p.valid, t);
  FloatVec<PX> tau2;
  if (p.tau2 != nullptr) {
    tau2 = load_stream<PX>(p.tau2, t);
  } else {
#pragma unroll
    for (int k = 0; k < PX; ++k) tau2.v[k] = p.tau2_value;
  }
  FloatVec<PX> mu_o, s2_o, a_o, b_o;
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    const FilterOut o = filter_pixel(mu.v[k], s2.v[k], a.v[k], b.v[k], x.v[k], tau2.v[k],
                                     v.v[k] != 0, p.mu_lo, p.mu_hi, p.uniform);
    mu_o.v[k] = o.mu;
    s2_o.v[k] = o.s2;
    a_o.v[k] = o.a;
    b_o.v[k] = o.b;
  }
  store_stream(p.mu_out, t, mu_o);
  store_stream(p.s2_out, t, s2_o);
  store_stream(p.a_out, t, a_o);
  store_stream(p.b_out, t, b_o);
}

template <int PX>
void launch(FilterArgs p, cudaStream_t st) {
  p.nvec = p.npix / PX;
  const long items = p.nvec + (p.npix - PX * p.nvec);
  const unsigned grid = static_cast<unsigned>((items + FILTER_THREADS - 1) / FILTER_THREADS);
  depth_filter_kernel<PX><<<grid, FILTER_THREADS, 0, st>>>(p);
}

}  // namespace

// mu, s2, a, b, x: (npix,) fp32; tau2: (npix,) fp32, or null (tau2_value
// used); valid: (npix,) bytes; the four outputs (npix,) fp32.
// uniform = 1 / (mu_hi - mu_lo) as the caller rounds it.
extern "C" int cvids_depth_filter(const void* mu, const void* s2, const void* a,
                                  const void* b, const void* x, const void* tau2,
                                  float tau2_value, const void* valid,
                                  float mu_lo, float mu_hi, float uniform, void* mu_out,
                                  void* s2_out, void* a_out, void* b_out, long npix,
                                  void* stream) {
  if (npix < 1) return static_cast<int>(cudaErrorInvalidValue);
  const void* maps[10] = {mu, s2, a, b, x, tau2, mu_out, s2_out, a_out, b_out};
  for (const void* q : maps)      // whole tensors: every map starts a 16-byte vector
    if (reinterpret_cast<uintptr_t>(q) & 15) return static_cast<int>(cudaErrorMisalignedAddress);
  FilterArgs p;
  p.mu = static_cast<const float*>(mu);
  p.s2 = static_cast<const float*>(s2);
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.x = static_cast<const float*>(x);
  p.tau2 = static_cast<const float*>(tau2);
  p.valid = static_cast<const uint8_t*>(valid);
  p.tau2_value = tau2_value;
  p.mu_lo = mu_lo;
  p.mu_hi = mu_hi;
  p.uniform = uniform;
  p.mu_out = static_cast<float*>(mu_out);
  p.s2_out = static_cast<float*>(s2_out);
  p.a_out = static_cast<float*>(a_out);
  p.b_out = static_cast<float*>(b_out);
  p.npix = npix;
  p.nvec = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  launch<FILTER_PIXELS>(p, st);
  return static_cast<int>(cudaGetLastError());
}
"""
PLAIN_STORE = """
template <typename T>
__device__ __forceinline__ void plain_store(T* p, T v) { *p = v; }
"""


_LIBS = {}


def build_variant(index: int, source: str, patches) -> None:
    """Point `_build` at a copy of csrc/ whose `source` is patched (a list of
    (old, new) pairs and functions of the text) or taken from the parent
    commit (a file name). Each variant's library is built and loaded once
    and kept: `main` loads them all before the first profiled call, because
    the profiler reports no device activity for a library loaded after its
    first trace."""
    if (source, index) in _LIBS:
        _build.CSRC, _build.BUILD_DIR, _build._lib = _LIBS[source, index]
        return
    vdir = ROOT / "build" / "variants" / f"{source[:-3]}_{index}"
    if not vdir.exists():
        shutil.copytree(_build._PKG / "csrc", vdir / "csrc")
        target = vdir / "csrc" / source
        if isinstance(patches, str):
            target.write_text((PARENT / patches).read_text())
            if source in STUBS:
                (vdir / "csrc" / "stubs.cu").write_text(STUBS[source])
        else:
            text = target.read_text()
            for patch in patches:
                if callable(patch):
                    text = patch(text)
                    continue
                old, new = patch
                if old not in text:
                    raise RuntimeError(f"{old!r} is not in {source}")
                text = text.replace(old, new)
            if "plain_store(" in text:
                text = text.replace("namespace {\n", "namespace {\n" + PLAIN_STORE, 1)
            target.write_text(text)
    _build.CSRC, _build.BUILD_DIR, _build._lib = vdir / "csrc", vdir / "cuda", None
    _LIBS[source, index] = (_build.CSRC, _build.BUILD_DIR, _build.load())


def three_times(fn, entry: str) -> str:
    alone = cs.time_ms(fn, 20)
    prof = f"{statistics.median(cs.profiled_kernel_ms(fn, entry) for _ in range(5)):.4f} ms"
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(200):
        fn()
    end.record()
    end.synchronize()
    return (f"alone {alone:.4f} ms, under the profiler {prof}, back to back "
            f"{start.elapsed_time(end) / 200:.4f} ms")


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    ham = {"160x512 masked": cs.hamming_inputs(rng, dev, 160, 512),
           "2048x2048": cs.hamming_inputs(rng, dev, 2048, 2048)[:2],
           "37x129 masked": cs.hamming_inputs(rng, dev, 37, 129)}
    ham_ref = {k: ck.hamming_matrix_twin(*v) for k, v in ham.items()}
    filt = {"480x640": cs.filter_inputs(rng, dev, cs.H, cs.W),
            "1080x1920": cs.filter_inputs(rng, dev, 1080, 1920),
            "37x53": cs.filter_inputs(rng, dev, 37, 53)}
    filt_ref = {k: ck.depth_filter_update_twin(st, x, 0.013, valid)
                for k, (st, x, valid) in filt.items()}
    have_parent = PARENT.exists()
    # every variant built, loaded and held to the twin before anything is timed
    for k, (name, patches) in enumerate(HAMMING.items()):
        if isinstance(patches, str) and not have_parent:
            continue
        build_variant(k, "hamming.cu", patches)
        for key, args in ham.items():
            if not torch.equal(ck.hamming_matrix(*args), ham_ref[key]):
                raise AssertionError(f"hamming {name}: {key} differs from the twin")
    for k, (name, patches) in enumerate(FILTER.items()):
        if isinstance(patches, str) and not have_parent:
            continue
        build_variant(k, "depth_filter.cu", patches)
        for key, (st, x, valid) in filt.items():
            for o, r in zip(ck.depth_filter_update(st, x, 0.013, valid), filt_ref[key]):
                if cs.ulp_distance(o, r) > cs.FILTER_MAX_ULP:
                    raise AssertionError(f"filter {name}: {key} differs from the twin")
    print(f"{len(_LIBS)} variants built and equal to the twins", flush=True)
    for round_ in range(2):
        for k, (name, patches) in enumerate(HAMMING.items()):
            if isinstance(patches, str) and not have_parent:
                continue
            build_variant(k, "hamming.cu", patches)
            small = three_times(lambda: ck.hamming_matrix(*ham["160x512 masked"]), "hamming_kernel")
            large = three_times(lambda: ck.hamming_matrix(*ham["2048x2048"]), "hamming_kernel")
            print(f"round {round_} hamming, {name}: 160x512 {small}; 2048x2048 {large}",
                  flush=True)
        for k, (name, patches) in enumerate(FILTER.items()):
            if isinstance(patches, str) and not have_parent:
                continue
            build_variant(k, "depth_filter.cu", patches)
            times = []
            for key in ("480x640", "1080x1920"):
                st, x, valid = filt[key]
                times.append(f"{key} " + three_times(
                    lambda: ck.depth_filter_update(st, x, 0.013, valid), "depth_filter_kernel"))
            print(f"round {round_} filter, {name}: {'; '.join(times)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
