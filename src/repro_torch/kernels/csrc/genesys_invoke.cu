// Hand-written Hopper (sm_90a) kernel of GENESYS's device-initiated system
// calls: the device entry of `Genesys.invoke`.
//
//   genesys_invoke
//       replaces no Pallas kernel. The JAX package reaches the host through
//       a host callback inside the jitted step (`Genesys.invoke` and
//       `Genesys._host_entry`, src/repro/core/genesys/invoke.py) and
//       emulates the GPU's atomic slot transitions with a lock. Here the
//       card's threads write the slots themselves (genesys_protocol.cuh)
//       into page-locked host memory mapped into the card's address space,
//       and a host thread (core/genesys/device.py) finds them READY and
//       rings the executor.
//
// One thread per row of the call's [n, 6, 2] int32 (lo, hi) arguments:
// a WORK_ITEM batch posts n slots, a WORK_GROUP or KERNEL call one. Row i
// goes to slot (base + i) % n_slots; the host turns `base` so that
// consecutive calls take fresh slots.
//
// What bounds it: latency, not bytes or operations. A call writes 64 bytes
// a row over PCIe and reads a state word back until the host answers; the
// host's dispatch of the call takes the rest. genesys_bare_respond below
// answers the same protocol with nothing behind it: its round trip is the
// floor of any device entry (chip_smoke.py phase 18).
//
// Built by src/repro_torch/kernels/_build.py and bound through ctypes: the
// entry points at the bottom have a plain C interface and return a CUDA
// error code.

#include <atomic>
#include <chrono>
#include <cstring>

#include "genesys_protocol.cuh"

namespace {

constexpr int64_t kETimedOut = 110;   // Linux ETIMEDOUT

// status [0] error code, [1] the slot it happened at (mapped host memory,
// read by the host without a CUDA call)
__device__ void report(int* status, int err, int slot) {
  volatile int* s = status;
  s[1] = slot;
  s[0] = err;
  __threadfence_system();
}

__global__ void genesys_invoke(genesys::Slot* area, int* owner, int n_slots,
                               int base, const int* __restrict__ rows,
                               int n_rows, uint32_t sysno, uint32_t flags,
                               uint32_t hw_id, int* retval, float* tag,
                               int* status, uint64_t timeout_ns) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows) return;
  uint64_t args[6];
  const int* r = rows + (size_t)i * 12;
  for (int j = 0; j < 6; ++j)
    args[j] = (uint64_t)(uint32_t)r[2 * j] |
              ((uint64_t)(uint32_t)r[2 * j + 1] << 32);
  const int slot = (int)(((long long)base + i) % n_slots);
  int err = genesys::genesys_post(area, owner, slot, sysno, args, flags,
                                  hw_id, genesys::now_ns() + timeout_ns);
  if (!(flags & genesys::kBlocking)) {
    if (err != genesys::kOk) report(status, err, slot);
    return;
  }
  uint64_t ret = 0;
  if (err == genesys::kOk)
    err = genesys::genesys_wait(area, owner, slot,
                                genesys::now_ns() + timeout_ns, &ret);
  if (err != genesys::kOk) {
    report(status, err, slot);
    ret = (uint64_t)(-kETimedOut);
  }
  retval[2 * i] = (int)(uint32_t)ret;
  retval[2 * i + 1] = (int)(uint32_t)(ret >> 32);
  if (tag != nullptr && i == 0) *tag = 0.0f;
}

}  // namespace

extern "C" {

// Page-locked host memory mapped into every card's address space; *host and
// *dev are its host and device addresses, the bytes zeroed (every slot FREE).
int genesys_mapped_alloc(long long nbytes, void** host, void** dev) {
  void* h = nullptr;
  cudaError_t err = cudaHostAlloc(&h, (size_t)nbytes,
                                  cudaHostAllocMapped | cudaHostAllocPortable);
  if (err != cudaSuccess) return err;
  std::memset(h, 0, (size_t)nbytes);
  void* d = nullptr;
  err = cudaHostGetDevicePointer(&d, h, 0);
  if (err != cudaSuccess) {
    cudaFreeHost(h);
    return err;
  }
  *host = h;
  *dev = d;
  return cudaSuccess;
}

int genesys_mapped_free(void* host) { return cudaFreeHost(host); }

// out[0] cudaDevAttrHostNativeAtomicSupported, [1] CanMapHostMemory,
// [2] UnifiedAddressing
int genesys_device_attributes(int device, int* out) {
  const cudaDeviceAttr attrs[3] = {cudaDevAttrHostNativeAtomicSupported,
                                   cudaDevAttrCanMapHostMemory,
                                   cudaDevAttrUnifiedAddressing};
  for (int k = 0; k < 3; ++k) {
    cudaError_t err = cudaDeviceGetAttribute(out + k, attrs[k], device);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// area: device address of n_slots slots; owner [n_slots] int32 in device
// memory; rows [n_rows, 6, 2] int32; retval [n_rows, 2] int32 (blocking
// calls only, else null); tag: a float the kernel sets to 0, which later
// work on the stream reads only after every row is answered (the
// post-barrier a caller ties work to; may be null); status [2] int32 in
// mapped host memory.
int genesys_invoke_launch(void* area, int* owner, int n_slots, int base,
                          const int* rows, int n_rows, int sysno, int flags,
                          int hw_id, int* retval, float* tag, int* status,
                          long long timeout_ns, void* stream) {
  const int threads = n_rows < 128 ? ((n_rows + 31) / 32) * 32 : 128;
  const int blocks = (n_rows + threads - 1) / threads;
  genesys_invoke<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<genesys::Slot*>(area), owner, n_slots, base, rows, n_rows,
      (uint32_t)sysno, (uint32_t)flags, (uint32_t)hw_id, retval, tag, status,
      (uint64_t)timeout_ns);
  return cudaGetLastError();
}

// The floor of any device entry's round trip: a bare host responder over
// n_slots slots of mapped host memory (host address) that marks each READY
// row answered at once (args[0] = 0; FINISHED for a blocking row, FREE for
// a non-blocking one), with no executor, dispatcher or handler. It spins on
// the calling thread until *stop is non-zero or timeout_ns has passed, and
// writes the rows it answered to *answered. Measurement only: a caller runs
// it on a thread of its own, through a handle that releases the GIL.
int genesys_bare_respond(void* host_area, int n_slots, const int* stop,
                         long long timeout_ns, long long* answered) {
  volatile genesys::Slot* slots = static_cast<genesys::Slot*>(host_area);
  const volatile int* halt = stop;
  const auto t0 = std::chrono::steady_clock::now();
  long long n = 0;
  for (unsigned round = 0; !*halt; ++round) {
    for (int i = 0; i < n_slots; ++i) {
      volatile genesys::Slot* s = slots + i;
      if (s->state != genesys::kReady) continue;
      std::atomic_thread_fence(std::memory_order_acquire);
      const uint32_t flags = s->flags;
      s->args[0] = 0;
      std::atomic_thread_fence(std::memory_order_release);
      s->state = (flags & genesys::kBlocking) ? genesys::kFinished
                                              : genesys::kFree;
      ++n;
    }
    if ((round & 1023) == 0 &&
        std::chrono::steady_clock::now() - t0 >
            std::chrono::nanoseconds(timeout_ns))
      break;
  }
  *answered = n;
  return 0;
}

}  // extern "C"
