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
//       and a host thread (core/genesys/device.py) finds them READY in
//       genesys_doorbell_wait below (genesys_doorbell.cuh: C, the GIL
//       released) and rings the executor.
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
// floor of any device entry (chip_smoke.py phase 18). Stamps on the card
// (GENESYS_INVOKE_STAMPS) put a one-row call's own time at ~9 us of it:
// the rest is the host's launch. So the design keeps the card's side
// short (a waiting row reads its state word about once a PCIe round trip,
// paced by the launch's rows so that a large batch does not fill the
// link) and the host's side out of Python where it waits.
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

// poll_ns: a waiting row's interval between reads of its state word
// (genesys::poll_interval_ns of the launch's rows)
__global__ void genesys_invoke(genesys::Slot* area, int* owner, int n_slots,
                               int base, const int* __restrict__ rows,
                               int n_rows, uint32_t sysno, uint32_t flags,
                               uint32_t hw_id, int* retval, float* tag,
                               int* status, uint64_t timeout_ns,
                               unsigned poll_ns) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows) return;
  genesys::stamp(0);
  uint64_t args[6];
  const int* r = rows + (size_t)i * 12;
  for (int j = 0; j < 6; ++j)
    args[j] = (uint64_t)(uint32_t)r[2 * j] |
              ((uint64_t)(uint32_t)r[2 * j + 1] << 32);
  const int slot = (int)(((long long)base + i) % n_slots);
  int err = genesys::genesys_post(area, owner, slot, sysno, args, flags,
                                  hw_id, genesys::now_ns() + timeout_ns,
                                  poll_ns);
  if (!(flags & genesys::kBlocking)) {
    if (err != genesys::kOk) report(status, err, slot);
    return;
  }
  uint64_t ret = 0;
  if (err == genesys::kOk)
    err = genesys::genesys_wait(area, owner, slot,
                                genesys::now_ns() + timeout_ns, poll_ns,
                                &ret);
  if (err != genesys::kOk) {
    report(status, err, slot);
    ret = (uint64_t)(-kETimedOut);
  }
  retval[2 * i] = (int)(uint32_t)ret;
  retval[2 * i + 1] = (int)(uint32_t)(ret >> 32);
  if (tag != nullptr && i == 0) *tag = 0.0f;
  genesys::stamp(4);
}

#ifdef GENESYS_INVOKE_STAMPS
// Measurement only: each of n_rows threads reads its slot's state word
// `reads` times back to back (system-scope acquire loads over PCIe, as
// wait_state's), so that reads / time is the card's rate of such reads.
__global__ void genesys_poll_reads(const genesys::Slot* area, int n_slots,
                                   int n_rows, int reads, int* sink) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows) return;
  const uint32_t* p = &area[i % n_slots].state;
  uint32_t acc = 0;
  for (int k = 0; k < reads; ++k) acc += genesys::load_state(p);
  if (acc == 0xFFFFFFFFu) *sink = (int)acc;
}
#endif

int launch_invoke(void* area, int* owner, int n_slots, int base,
                  const int* rows, int n_rows, int sysno, int flags,
                  int hw_id, int* retval, float* tag, int* status,
                  long long timeout_ns, void* stream, unsigned poll_ns) {
  const int threads = n_rows < 128 ? ((n_rows + 31) / 32) * 32 : 128;
  const int blocks = (n_rows + threads - 1) / threads;
  genesys_invoke<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<genesys::Slot*>(area), owner, n_slots, base, rows, n_rows,
      (uint32_t)sysno, (uint32_t)flags, (uint32_t)hw_id, retval, tag, status,
      (uint64_t)timeout_ns, poll_ns);
  return cudaGetLastError();
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
  return launch_invoke(area, owner, n_slots, base, rows, n_rows, sysno,
                       flags, hw_id, retval, tag, status, timeout_ns, stream,
                       genesys::poll_interval_ns(n_rows));
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

// One pass of the host's doorbell (genesys_doorbell.cuh) over `count`
// slots from `first` on: up to max_out READY slots whose rung[] byte is 0
// written to out; returns how many. No spin: a caller may hold the GIL.
int genesys_doorbell_scan(const void* host_area, int n_slots, int first,
                          int count, const unsigned char* rung, int* out,
                          int max_out) {
  return genesys::doorbell_scan(host_area, n_slots, first, count, rung, out,
                                max_out);
}

// The host's doorbell (genesys_doorbell.cuh): spin on the state words of
// `count` slots from `first` on (host address of n_slots slots) until a
// pass finds READY slots whose rung[] byte is 0, and write up to max_out
// of them to out; return how many, or 0 once *generation != seen, *stop
// is set or spin_ns have passed. A caller runs it through a handle that
// releases the GIL.
int genesys_doorbell_wait(const void* host_area, int n_slots, int first,
                          int count, const unsigned char* rung, int* out,
                          int max_out, const long long* generation,
                          long long seen, const int* stop,
                          long long spin_ns) {
  return genesys::doorbell_wait(host_area, n_slots, first, count, rung, out,
                                max_out,
                                reinterpret_cast<const int64_t*>(generation),
                                seen, stop, spin_ns);
}

#ifdef GENESYS_INVOKE_STAMPS
// The same launch with the exponential backoff the wait took before the
// paced wait, to read the two in turns (chip_smoke.py phase 18's bare
// responder, experiments/torch_invoke_latency.py --stamps).
int genesys_invoke_backoff_launch(void* area, int* owner, int n_slots,
                                  int base, const int* rows, int n_rows,
                                  int sysno, int flags, int hw_id,
                                  int* retval, float* tag, int* status,
                                  long long timeout_ns, void* stream) {
  return launch_invoke(area, owner, n_slots, base, rows, n_rows, sysno,
                       flags, hw_id, retval, tag, status, timeout_ns, stream,
                       genesys::kBackoff);
}

// The stamps of the last calls (genesys_protocol.cuh): n words of
// invoke_stamps into host memory dst.
int genesys_invoke_stamps_read(void* dst, int n) {
  if (n < 0 || n > genesys::kStampRows * genesys::kStamps)
    return cudaErrorInvalidValue;
  return cudaMemcpyFromSymbol(dst, genesys::invoke_stamps,
                              (size_t)n * sizeof(unsigned long long));
}

int genesys_poll_reads_launch(const void* area, int n_slots, int n_rows,
                              int reads, int* sink, void* stream) {
  const int threads = n_rows < 128 ? ((n_rows + 31) / 32) * 32 : 128;
  genesys_poll_reads<<<(n_rows + threads - 1) / threads, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const genesys::Slot*>(area), n_slots, n_rows, reads, sink);
  return cudaGetLastError();
}
#endif

}  // extern "C"
