// Error reporting of the kernel entry points' C interface.
#include <cstdarg>
#include <cstdio>

#include "common.cuh"

namespace {
// The last refusal's message on this thread, "" once it has been read.
thread_local char refusal[512];
}  // namespace

int refuse(const char* fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(refusal, sizeof refusal, fmt, ap);
  va_end(ap);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The message for a code an entry point returned: the entry point's own
// refusal when it made one (read once), else CUDA's string for the code.
extern "C" const char* repro_kernels_error_string(int code) {
  thread_local char out[sizeof refusal];
  if (refusal[0] != '\0') {
    snprintf(out, sizeof out, "%s", refusal);
    refusal[0] = '\0';
    return out;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
