// Bounded thread-safe queue — counterpart of the reference's
// cxx/SafeQueue.h:7-52, extended with a capacity bound so producers
// block instead of ballooning memory (the reference bounded its buffer
// pool manually in the consumer loop, tf_inference.cpp:367-380).
#pragma once

#include <condition_variable>
#include <mutex>
#include <optional>
#include <queue>

namespace vnet {

template <typename T>
class SafeQueue {
 public:
  explicit SafeQueue(size_t capacity = SIZE_MAX) : capacity_(capacity) {}

  void Push(T value) {
    std::unique_lock<std::mutex> lock(mu_);
    not_full_.wait(lock,
                   [this] { return queue_.size() < capacity_ || closed_; });
    if (closed_) return;
    queue_.push(std::move(value));
    not_empty_.notify_one();
  }

  // Blocks until an item is available or the queue is closed; returns
  // nullopt on closed+empty.
  std::optional<T> Pop() {
    std::unique_lock<std::mutex> lock(mu_);
    not_empty_.wait(lock, [this] { return !queue_.empty() || closed_; });
    if (queue_.empty()) return std::nullopt;
    T value = std::move(queue_.front());
    queue_.pop();
    not_full_.notify_one();
    return value;
  }

  void Close() {
    std::lock_guard<std::mutex> lock(mu_);
    closed_ = true;
    not_empty_.notify_all();
    not_full_.notify_all();
  }

  size_t Size() const {
    std::lock_guard<std::mutex> lock(mu_);
    return queue_.size();
  }

 private:
  mutable std::mutex mu_;
  std::condition_variable not_empty_;
  std::condition_variable not_full_;
  std::queue<T> queue_;
  size_t capacity_;
  bool closed_ = false;
};

}  // namespace vnet
