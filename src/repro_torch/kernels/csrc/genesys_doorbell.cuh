// GENESYS's slot layout and the host's doorbell over it, in plain C++ (no
// CUDA): the card's side of the protocol is genesys_protocol.cuh, which
// includes this header for the layout.
//
//   doorbell_scan  one pass over the state words of the slots that
//                  outstanding launches post into: the READY slots the
//                  host has not rung yet
//   doorbell_wait  the host thread that answers the card spins here,
//                  passing over them until one turns READY
//
// The slots live in page-locked host memory that the card writes over
// PCIe, so each read of a state word is a read of host memory (the card's
// writes land in it); the spin pauses between rounds. Its caller holds no
// interpreter lock while it spins (core/genesys/device.py calls the wait
// through a ctypes.CDLL handle) and takes the lock only to ring the
// executor; it makes one pass first without letting the lock go.
#pragma once

#include <chrono>
#include <cstdint>

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

// Host code: nvcc parses it in its device pass too, where it emits none.
inline void spin_pause() {
#if defined(__CUDA_ARCH__)
#elif defined(__x86_64__) || defined(__i386__)
  asm volatile("pause" ::: "memory");
#elif defined(__aarch64__)
  asm volatile("yield" ::: "memory");
#endif
}

// One pass over the window of `count` slots from `first` on (mod n_slots,
// count <= n_slots): the READY slots whose rung[] byte is 0, in window
// order, at most max_out of them written to out. Returns how many (0 for
// a window outside the area).
inline int doorbell_scan(const void* host_area, int n_slots, int first,
                         int count, const uint8_t* rung_bytes, int* out,
                         int max_out) {
  const volatile Slot* slots = static_cast<const volatile Slot*>(host_area);
  const volatile uint8_t* rung = rung_bytes;
  if (first < 0 || count < 0 || count > n_slots || first >= n_slots)
    return 0;
  int k = 0;
  for (int j = 0; j < count && k < max_out; ++j) {
    int s = first + j;
    if (s >= n_slots) s -= n_slots;
    if (slots[s].state == kReady && !rung[s]) out[k++] = s;
  }
  return k;
}

// Spin on the window until a pass finds READY slots not yet rung (returns
// their number, > 0), or return 0 as soon as *generation != seen (a new
// launch must be watched), *stop != 0, or spin_ns have passed.
inline int doorbell_wait(const void* host_area, int n_slots, int first,
                         int count, const uint8_t* rung, int* out,
                         int max_out, const int64_t* generation,
                         int64_t seen, const int32_t* stop,
                         int64_t spin_ns) {
  const volatile int64_t* gen = generation;
  const volatile int32_t* halt = stop;
  const auto deadline = std::chrono::steady_clock::now() +
                        std::chrono::nanoseconds(spin_ns);
  for (unsigned round = 0;; ++round) {
    const int k = doorbell_scan(host_area, n_slots, first, count, rung, out,
                                max_out);
    if (k) return k;
    if (*halt || *gen != seen) return 0;
    if ((round & 15) == 15 && std::chrono::steady_clock::now() > deadline)
      return 0;
    spin_pause();
  }
}

}  // namespace genesys
