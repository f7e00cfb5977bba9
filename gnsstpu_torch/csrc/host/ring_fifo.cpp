// Blocking ring FIFO of fixed-size sample blocks (host feed fabric).
//
// Native equivalent of the reference's FIFO thread (objects/fifo.cpp:
// 53-187: 4000-deep ring of 1 ms ms_packets with sem_full/sem_empty
// producer-consumer semantics and overrun counting). The TPU framework
// uses it between a live sample source thread and the host->device feed:
// the producer never blocks the radio (drop + count overruns when full,
// like the reference's FIFO telemetry "FIFO: 999 9801..." doxygen.h:113),
// the consumer blocks with a timeout (Patience-style stall detection on
// timeout expiry).

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

struct RingFifo {
  std::vector<uint8_t> buf;
  int64_t block_bytes = 0;
  int64_t depth = 0;
  int64_t head = 0;    // next write slot
  int64_t tail = 0;    // next read slot
  int64_t count = 0;
  int64_t pushed = 0;
  int64_t popped = 0;
  int64_t overruns = 0;
  std::mutex mu;
  std::condition_variable cv_nonempty;
  std::condition_variable cv_nonfull;
  bool closed = false;
};

}  // namespace

extern "C" {

void* fifo_create(int64_t depth, int64_t block_bytes) {
  auto* f = new RingFifo();
  f->depth = depth;
  f->block_bytes = block_bytes;
  f->buf.resize(static_cast<size_t>(depth * block_bytes));
  return f;
}

void fifo_destroy(void* h) { delete static_cast<RingFifo*>(h); }

void fifo_close(void* h) {
  auto* f = static_cast<RingFifo*>(h);
  std::lock_guard<std::mutex> g(f->mu);
  f->closed = true;
  f->cv_nonempty.notify_all();
  f->cv_nonfull.notify_all();
}

// Non-blocking push (radio side): returns 1 on success, 0 if the ring is
// full (the block is dropped and the overrun counter bumped).
int fifo_push(void* h, const uint8_t* block) {
  auto* f = static_cast<RingFifo*>(h);
  std::lock_guard<std::mutex> g(f->mu);
  if (f->count == f->depth) {
    ++f->overruns;
    return 0;
  }
  std::memcpy(&f->buf[f->head * f->block_bytes], block,
              static_cast<size_t>(f->block_bytes));
  f->head = (f->head + 1) % f->depth;
  ++f->count;
  ++f->pushed;
  f->cv_nonempty.notify_one();
  return 1;
}

// Blocking push with timeout (file/backpressure producers).
int fifo_push_wait(void* h, const uint8_t* block, int64_t timeout_ms) {
  auto* f = static_cast<RingFifo*>(h);
  std::unique_lock<std::mutex> g(f->mu);
  if (!f->cv_nonfull.wait_for(
          g, std::chrono::milliseconds(timeout_ms),
          [&] { return f->count < f->depth || f->closed; }))
    return 0;
  if (f->closed) return -1;
  std::memcpy(&f->buf[f->head * f->block_bytes], block,
              static_cast<size_t>(f->block_bytes));
  f->head = (f->head + 1) % f->depth;
  ++f->count;
  ++f->pushed;
  f->cv_nonempty.notify_one();
  return 1;
}

// Blocking pop with timeout: 1 = got a block, 0 = timeout (stalled
// source — Patience semantics), -1 = closed and drained.
int fifo_pop(void* h, uint8_t* block, int64_t timeout_ms) {
  auto* f = static_cast<RingFifo*>(h);
  std::unique_lock<std::mutex> g(f->mu);
  if (!f->cv_nonempty.wait_for(
          g, std::chrono::milliseconds(timeout_ms),
          [&] { return f->count > 0 || f->closed; }))
    return 0;
  if (f->count == 0) return -1;
  std::memcpy(block, &f->buf[f->tail * f->block_bytes],
              static_cast<size_t>(f->block_bytes));
  f->tail = (f->tail + 1) % f->depth;
  --f->count;
  ++f->popped;
  f->cv_nonfull.notify_one();
  return 1;
}

// stats[4] = {count, pushed, popped, overruns}.
void fifo_stats(void* h, int64_t* stats) {
  auto* f = static_cast<RingFifo*>(h);
  std::lock_guard<std::mutex> g(f->mu);
  stats[0] = f->count;
  stats[1] = f->pushed;
  stats[2] = f->popped;
  stats[3] = f->overruns;
}

}  // extern "C"
