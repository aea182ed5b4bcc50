// GENESYS's slot protocol on the card: a thread posts one system call into
// a 64-byte slot of the syscall area (page-locked host memory mapped into
// the card's address space) and, for a blocking call, waits for the host's
// answer in the same slot.
//
//   genesys_post   FREE -> POPULATING, payload, READY      (the card)
//   genesys_wait   FINISHED -> FREE, retval = args[0]       (the card)
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
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace genesys {

// core/genesys/area.py: SLOT_DTYPE (numpy, align=True), one cache line
struct Slot {
  uint32_t sysno;
  uint32_t state;
  uint64_t args[6];   // args[0] doubles as the return value
  uint32_t flags;     // bit 0: blocking
  uint32_t hw_id;
};
static_assert(sizeof(Slot) == 64, "a slot is one 64-byte line");

// core/genesys/area.py: SlotState and FLAG_BLOCKING
constexpr uint32_t kFree = 0, kPopulating = 1, kReady = 2, kProcessing = 3,
                   kFinished = 4;
constexpr uint32_t kBlocking = 0x1;

// what a bound that runs out reports (kernels/genesys_invoke.py names them)
constexpr int kOk = 0, kOwnerTimeout = 1, kFreeTimeout = 2,
              kFinishTimeout = 3;

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

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

// Back off between polls: each poll of a state word is a read over PCIe,
// and a batch of thousands of threads polling at once would fill the link.
__device__ __forceinline__ void backoff(unsigned& ns) {
  __nanosleep(ns);
  if (ns < 32768) ns <<= 1;
}

__device__ __forceinline__ bool wait_state(const uint32_t* p, uint32_t want,
                                           uint64_t deadline) {
  unsigned ns = 256;
  while (load_state(p) != want) {
    if (now_ns() > deadline) return false;
    backoff(ns);
  }
  return true;
}

// Post one call into `slot`. A slot still held by an earlier call (another
// thread's, or the host's processing of a non-blocking one) delays the
// invocation until it is FREE, as the paper's area does when it is full.
// A blocking call keeps the slot's owner word until genesys_wait frees it;
// a non-blocking call gives it back at once (the host frees the slot).
__device__ inline int genesys_post(Slot* area, int* owner, int slot,
                                   uint32_t sysno, const uint64_t args[6],
                                   uint32_t flags, uint32_t hw_id,
                                   uint64_t deadline) {
  unsigned ns = 128;
  while (atomicCAS(owner + slot, 0, 1) != 0) {
    if (now_ns() > deadline) return kOwnerTimeout;
    backoff(ns);
  }
  __threadfence();
  Slot* s = area + slot;
  if (!wait_state(&s->state, kFree, deadline)) {
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
                                   uint64_t deadline, uint64_t* ret) {
  Slot* s = area + slot;
  if (!wait_state(&s->state, kFinished, deadline)) return kFinishTimeout;
  volatile Slot* v = s;
  *ret = v->args[0];
  v->state = kFree;
  __threadfence_system();
  atomicExch(owner + slot, 0);
  return kOk;
}

}  // namespace genesys
