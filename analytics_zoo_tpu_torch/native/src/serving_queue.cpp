// Blocking model-pool queue — the serving concurrency core of the
// reference's InferenceModel (reference
// `Z/pipeline/inference/InferenceModel.scala:32-38`: a
// LinkedBlockingQueue holding `supportedConcurrentNum` weight-sharing
// model copies; threads take a model, predict, put it back).
//
// Here the queue holds integer slot ids referencing compiled executables
// on the Python side; take() blocks with an optional timeout so a
// serving facade can bound latency.

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <mutex>
#include <queue>

namespace {

struct SQueue {
  std::mutex mu;
  std::condition_variable cv;
  std::queue<int> items;
};

}  // namespace

extern "C" {

void* squeue_create() { return new SQueue(); }

void squeue_destroy(void* handle) {
  delete static_cast<SQueue*>(handle);
}

void squeue_put(void* handle, int id) {
  SQueue* q = static_cast<SQueue*>(handle);
  {
    std::lock_guard<std::mutex> lock(q->mu);
    q->items.push(id);
  }
  q->cv.notify_one();
}

// Returns the taken id, or -1 on timeout. timeout_ms < 0 waits forever.
int squeue_take(void* handle, long timeout_ms) {
  SQueue* q = static_cast<SQueue*>(handle);
  std::unique_lock<std::mutex> lock(q->mu);
  auto ready = [q] { return !q->items.empty(); };
  if (timeout_ms < 0) {
    q->cv.wait(lock, ready);
  } else if (!q->cv.wait_for(lock, std::chrono::milliseconds(timeout_ms),
                             ready)) {
    return -1;
  }
  int id = q->items.front();
  q->items.pop();
  return id;
}

int squeue_size(void* handle) {
  SQueue* q = static_cast<SQueue*>(handle);
  std::lock_guard<std::mutex> lock(q->mu);
  return static_cast<int>(q->items.size());
}

}  // extern "C"
