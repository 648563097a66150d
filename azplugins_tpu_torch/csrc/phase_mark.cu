// Device phase marks: an empty kernel a phase of a rebuild segment, which
// the tracer (trace.py) launches on the current stream as the phase begins.
// Each phase id is a template instance of its own, so a device trace names
// the phase by the kernel's demangled name, az_phase_mark<id>, at the
// device's own timestamps; the tracer's mark_table maps the id to the
// phase. The marks are captured into the segment CUDA graphs with the rest
// of a segment's work, so a profiled replay splits its device operations by
// phase. A mark reads and writes nothing: one block of one thread that
// returns at once.

#include <cuda_runtime.h>

namespace {

constexpr int kMarks = 64;  // trace.py's N_MARKS

template <int ID>
__global__ void az_phase_mark() {}

static_assert(kMarks == 64, "the launch table below lists 64 instances");

}  // namespace

extern "C" {

// Launch the mark of phase `id` (0 <= id < kMarks) on `stream`; returns the
// CUDA error (0 = launched).
int az_phase_mark_launch(int id, void* stream) {
  static const void* const kKernels[kMarks] = {
#define AZ_MARK8(b)                                                                          \
  (const void*)&az_phase_mark<b + 0>, (const void*)&az_phase_mark<b + 1>,                    \
      (const void*)&az_phase_mark<b + 2>, (const void*)&az_phase_mark<b + 3>,                \
      (const void*)&az_phase_mark<b + 4>, (const void*)&az_phase_mark<b + 5>,                \
      (const void*)&az_phase_mark<b + 6>, (const void*)&az_phase_mark<b + 7>
      AZ_MARK8(0), AZ_MARK8(8), AZ_MARK8(16), AZ_MARK8(24),
      AZ_MARK8(32), AZ_MARK8(40), AZ_MARK8(48), AZ_MARK8(56)
#undef AZ_MARK8
  };
  if (id < 0 || id >= kMarks) return (int)cudaErrorInvalidValue;
  return (int)cudaLaunchKernel(kKernels[id], dim3(1), dim3(1), nullptr, 0,
                               static_cast<cudaStream_t>(stream));
}

const char* az_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
