// ipc.cu: the CUDA IPC memory of the kernels across processes (ops/ipc.py).
//
// Replaces no TPU kernel. On the TPU a Pallas kernel addresses a peer
// chip's buffer by its mesh coordinates; here a process exports one device
// allocation (its rows and flag words) as a CUDA IPC handle, and every peer
// process opens it, on the same card or, with peer access enabled at open,
// on another card over NVLink. The ring and alltoall kernels then read and
// write the peers' rows through the opened pointers (ring.cu and
// alltoall.cu, the *_rank entry points). Nothing here runs on the device:
// it allocates, exports, opens and frees, and it keeps the mapped host
// words the kernels' bounded waits write their record into (common.cuh,
// RNR_DIAG_*).
#include <string.h>

#include "common.cuh"

// sizeof(cudaIpcMemHandle_t): the bytes of a handle the wrapper exchanges.
extern "C" int rnr_ipc_handle_bytes() { return (int)sizeof(cudaIpcMemHandle_t); }

// `bytes` of device memory on `device`, zeroed, into *ptr, and its IPC
// handle into `handle` (rnr_ipc_handle_bytes() bytes).
extern "C" int rnr_ipc_alloc(long long bytes, int device, void** ptr, void* handle) {
  if (bytes <= 0 || ptr == nullptr || handle == nullptr) return (int)cudaErrorInvalidValue;
  return rnr_on_device(device, [&] {
    cudaError_t e = cudaMalloc(ptr, (size_t)bytes);
    if (e != cudaSuccess) return (int)e;
    // zeroed before any peer can see it: the flag words start at 0
    if ((e = cudaMemset(*ptr, 0, (size_t)bytes)) == cudaSuccess &&
        (e = cudaDeviceSynchronize()) == cudaSuccess &&
        (e = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *ptr)) ==
            cudaSuccess)
      return 0;
    cudaFree(*ptr);
    *ptr = nullptr;
    return (int)e;
  });
}

// Map a peer process's allocation (its handle) into this process on
// `device`: *ptr is its base here. Peer access is enabled on the way, so an
// allocation on another card is read and written over NVLink.
extern "C" int rnr_ipc_open(const void* handle, int device, void** ptr) {
  if (handle == nullptr || ptr == nullptr) return (int)cudaErrorInvalidValue;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof h);
  return rnr_on_device(device, [&] {
    return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
  });
}

// Unmap what rnr_ipc_open mapped.
extern "C" int rnr_ipc_close(void* ptr, int device) {
  return rnr_on_device(device, [&] { return (int)cudaIpcCloseMemHandle(ptr); });
}

// Free what rnr_ipc_alloc allocated.
extern "C" int rnr_ipc_free(void* ptr, int device) {
  return rnr_on_device(device, [&] { return (int)cudaFree(ptr); });
}

// The process's diagnostic words (RNR_DIAG_WORDS, zeroed once): pinned host
// memory mapped into every device, *host its address here, *dev the one a
// kernel writes to. Allocated at the first call, kept for the process's
// life; the host reads it also after a trap has failed the context.
extern "C" int rnr_ipc_diag(void** host, void** dev) {
  static void* h = nullptr;
  static void* d = nullptr;
  if (h == nullptr) {
    void* p = nullptr;
    cudaError_t e = cudaHostAlloc(&p, RNR_DIAG_WORDS * sizeof(unsigned),
                                  cudaHostAllocMapped | cudaHostAllocPortable);
    if (e != cudaSuccess) return (int)e;
    memset(p, 0, RNR_DIAG_WORDS * sizeof(unsigned));
    if ((e = cudaHostGetDevicePointer(&d, p, 0)) != cudaSuccess) {
      cudaFreeHost(p);
      return (int)e;
    }
    h = p;
  }
  *host = h;
  *dev = d;
  return 0;
}

extern "C" const char* rnr_ipc_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
