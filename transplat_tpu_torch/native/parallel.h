// A minimal parallel-for over n items on up to num_threads host threads.
#pragma once

#include <algorithm>
#include <atomic>
#include <functional>
#include <thread>
#include <vector>

namespace tp {

inline void parallel_for(int n, int num_threads, const std::function<void(int)>& fn) {
  if (num_threads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next{0};
  std::vector<std::thread> pool;
  const int workers = std::min(num_threads, n);
  pool.reserve(workers);
  for (int t = 0; t < workers; ++t) {
    pool.emplace_back([&] {
      for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace tp
