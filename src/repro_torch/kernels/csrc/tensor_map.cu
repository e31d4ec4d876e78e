// TMA tensor maps of the wgmma kernels (flash_attention.cu,
// paged_attention.cu), encoded on the host.
#include "common.cuh"

namespace {

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link
// against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled lookup() {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t rc = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t rc = cudaGetDriverEntryPoint(
      "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
  return rc == cudaSuccess && found == cudaDriverEntryPointSuccess
             ? reinterpret_cast<EncodeTiled>(p)
             : nullptr;
}

}  // namespace

int tensor_map_4d(CUtensorMap* map, const char* who, CUtensorMapDataType type,
                  const void* base, const cuuint64_t (&dims)[4],
                  const cuuint64_t (&strides)[3], const cuuint32_t (&box)[4],
                  CUtensorMapSwizzle swizzle) {
  static const EncodeTiled encode = lookup();
  if (encode == nullptr)
    return refuse("%s: cuTensorMapEncodeTiled not found "
                  "(cudaGetDriverEntryPoint)", who);
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult rc = encode(
      map, type, 4, const_cast<void*>(base), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (rc != CUDA_SUCCESS)
    return refuse("%s: cuTensorMapEncodeTiled failed (%d) for dims %llu x "
                  "%llu x %llu x %llu, box %u x %u x %u x %u", who,
                  static_cast<int>(rc),
                  static_cast<unsigned long long>(dims[0]),
                  static_cast<unsigned long long>(dims[1]),
                  static_cast<unsigned long long>(dims[2]),
                  static_cast<unsigned long long>(dims[3]), box[0], box[1],
                  box[2], box[3]);
  return 0;
}
