// GENESYS's slot protocol on the card: a thread posts one system call into
// a 64-byte slot of the syscall area (page-locked host memory mapped into
// the card's address space) and, for a blocking call, waits for the host's
// answer in the same slot.
//
//   genesys_post   FREE -> POPULATING, payload, READY      (the card)
//   genesys_wait   FINISHED -> FREE, retval = args[0]       (the card)
//
// A waiting thread reads its state word at a pace set by its launch's
// row count (poll_interval_ns).
//
// The host side (src/repro_torch/core/genesys/device.py and the executor)
// writes READY -> PROCESSING -> FINISHED, or -> FREE for a non-blocking
// call, under its area lock. Each state word so has one writer at a time.
//
// Ownership of a slot among the card's threads is decided by an atomic on
// one owner word per slot in device memory, never by an atomic on the
// mapped host memory: over PCIe such an atomic is not atomic with respect
// to the host (cudaDevAttrHostNativeAtomicSupported is 0 on an x86 host).
//
// Every spin is bounded by %globaltimer: when a bound runs out the function
// returns an error code and the caller reports it, so a stalled host fails
// the launch instead of hanging the card.
//
// The functions are device functions so that any kernel can invoke a
// system call from inside its own body; kernels/csrc/genesys_invoke.cu is
// the entry kernel of `Genesys.invoke`.
//
// Built with GENESYS_INVOKE_STAMPS defined (a copy of the sources with the
// macro: chip_smoke.py phase 18, the --stamps build of
// experiments/torch_invoke_latency.py), each thread records %globaltimer
// in invoke_stamps at its row's steps: 0 kernel entry, 1 owner word taken,
// 2 READY stored, 3 FINISHED seen, 4 exit. Each call overwrites its rows.
// That build also keeps the backoff the paced wait replaced (kBackoff).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "genesys_doorbell.cuh"   // Slot, the states

namespace genesys {

// what a bound that runs out reports (kernels/genesys_invoke.py names them)
constexpr int kOk = 0, kOwnerTimeout = 1, kFreeTimeout = 2,
              kFinishTimeout = 3;

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

#ifdef GENESYS_INVOKE_STAMPS
constexpr int kStampRows = 4096;
constexpr int kStamps = 5;
__device__ unsigned long long invoke_stamps[kStampRows * kStamps];
__device__ __forceinline__ void stamp(int i) {
  const unsigned row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row < kStampRows) invoke_stamps[row * kStamps + i] = now_ns();
}
#else
__device__ __forceinline__ void stamp(int) {}
#endif

// A state word the host writes, read with system-scope acquire: the loads
// after it (the retval) see what the host wrote before it.
__device__ __forceinline__ uint32_t load_state(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_state(uint32_t* p, uint32_t v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// Back off between attempts on an owner word (device memory, never PCIe).
__device__ __forceinline__ void backoff(unsigned& ns) {
  __nanosleep(ns);
  if (ns < 32768) ns <<= 1;
}

// A thread waiting on a state word reads it over PCIe once every poll_ns:
// about once a read's round trip (1.2-1.3 us on an H100 80GB HBM3 at
// 700 W, experiments/torch_invoke_latency.py --stamps) while a launch has
// few rows, and spaced so that a launch's rows together read no more than
// kPollReadsPerS, a tenth of the ~5.0e8 reads a second at which the
// card's reads of mapped host memory saturate (1024 and 4096 threads
// reading at once, the same runs), once it has more than
// kPollReadsPerS * 1 us of them. A 4096-row batch then reads each word
// every 82 us, which its ~0.2 s in the host's hands does not notice.
constexpr double kPollReadsPerS = 5e7;
constexpr unsigned kMinPollNs = 1000, kMaxPollNs = 1000000;

__host__ __device__ __forceinline__ unsigned poll_interval_ns(int rows) {
  const double ns = rows * (1e9 / kPollReadsPerS);
  return ns < kMinPollNs ? kMinPollNs
                         : ns > kMaxPollNs ? kMaxPollNs : (unsigned)ns;
}

#ifdef GENESYS_INVOKE_STAMPS
// poll_ns == kBackoff: the exponential backoff this wait took before (256
// ns doubling up to 32.8 us between reads), built only here, to be read
// beside the paced wait (genesys_invoke_backoff_launch)
constexpr unsigned kBackoff = 0;
#endif

__device__ __forceinline__ bool wait_state(const uint32_t* p, uint32_t want,
                                           uint64_t deadline,
                                           unsigned poll_ns) {
#ifdef GENESYS_INVOKE_STAMPS
  if (poll_ns == kBackoff) {
    unsigned ns = 256;
    while (load_state(p) != want) {
      if (now_ns() > deadline) return false;
      backoff(ns);
    }
    return true;
  }
#endif
  for (;;) {
    const uint64_t t = now_ns();
    if (load_state(p) == want) return true;
    if (t > deadline) return false;
    // __nanosleep may wake early: sleep until the next read is due
    const uint64_t next = t + poll_ns;
    for (uint64_t now = now_ns(); now < next; now = now_ns())
      __nanosleep((unsigned)(next - now));
  }
}

// Post one call into `slot`. A slot still held by an earlier call (another
// thread's, or the host's processing of a non-blocking one) delays the
// invocation until it is FREE, as the paper's area does when it is full.
// A blocking call keeps the slot's owner word until genesys_wait frees it;
// a non-blocking call gives it back at once (the host frees the slot).
__device__ inline int genesys_post(Slot* area, int* owner, int slot,
                                   uint32_t sysno, const uint64_t args[6],
                                   uint32_t flags, uint32_t hw_id,
                                   uint64_t deadline, unsigned poll_ns) {
  unsigned ns = 128;
  while (atomicCAS(owner + slot, 0, 1) != 0) {
    if (now_ns() > deadline) return kOwnerTimeout;
    backoff(ns);
  }
  stamp(1);
  __threadfence();
  Slot* s = area + slot;
  if (!wait_state(&s->state, kFree, deadline, poll_ns)) {
    __threadfence();
    atomicExch(owner + slot, 0);
    return kFreeTimeout;
  }
  volatile Slot* v = s;
  v->state = kPopulating;
  v->sysno = sysno;
  for (int j = 0; j < 6; ++j) v->args[j] = args[j];
  v->flags = flags;
  v->hw_id = hw_id;
  __threadfence_system();          // the payload is visible before READY
  store_state(&s->state, kReady);
  stamp(2);
  if (!(flags & kBlocking)) {
    __threadfence();
    atomicExch(owner + slot, 0);
  }
  return kOk;
}

// Wait for the host's answer to a blocking call posted into `slot`, take
// the return value and free the slot. A bound that runs out leaves the
// slot held: the host may still answer it, and no other thread may reuse it.
__device__ inline int genesys_wait(Slot* area, int* owner, int slot,
                                   uint64_t deadline, unsigned poll_ns,
                                   uint64_t* ret) {
  Slot* s = area + slot;
  if (!wait_state(&s->state, kFinished, deadline, poll_ns))
    return kFinishTimeout;
  stamp(3);
  volatile Slot* v = s;
  *ret = v->args[0];
  v->state = kFree;
  __threadfence_system();
  atomicExch(owner + slot, 0);
  return kOk;
}

}  // namespace genesys
