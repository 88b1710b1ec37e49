// A kernel that does nothing: the yardstick of the launch path.
//
// Timed as every other kernel of the library is timed (through the wrappers'
// launch function, on PyTorch's current stream, between CUDA events), it gives
// the launch floor: the time a call takes on this card however little work it
// has. A kernel whose whole work is microseconds (the Hamming matrix of one
// loop verification, the depth filter, the banded warp) cannot read below it,
// whatever its roofline bound says. It replaces no kernel of the reference.

#include "common.cuh"

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int cvids_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
