// Launch counts, by kernel, of one library of the port.
//
// Every launch site adds one to its kernel's count right where it launches
// (count_launch), so a test or chip_smoke.py can tell which kernels a call
// ran and how often, without a profiler (torch.profiler drops kernels in
// long card processes).  Each csrc/<name>.cu is built into a library of its
// own from that one translation unit, so each library keeps its own counts,
// for as long as the process lives; vitta_launch_counts hands them to
// ops/_launch.py, which adds them up over the loaded libraries.  Also the
// card's SM count, which the launch plans read (sm_count).

#pragma once
#include <cuda_runtime.h>

#include <mutex>
#include <string>
#include <utility>
#include <vector>

namespace vitta {
// Internal linkage, so that each library keeps counts of its own: a static
// of an inline function with external linkage is one object for the whole
// process (a unique global symbol), however the libraries are loaded.
namespace {

struct LaunchCounts {
  std::mutex mu;
  std::vector<std::pair<std::string, long long>> by_name;
};

inline LaunchCounts& launch_counts() {
  static LaunchCounts counts;
  return counts;
}

// One more launch of the kernel called `name`.
inline void count_launch(const char* name) {
  LaunchCounts& c = launch_counts();
  const std::lock_guard<std::mutex> lock(c.mu);
  for (auto& entry : c.by_name)
    if (entry.first == name) {
      ++entry.second;
      return;
    }
  c.by_name.emplace_back(name, 1);
}

inline std::string template_arg(bool v) { return v ? "true" : "false"; }
inline std::string template_arg(int v) { return std::to_string(v); }

// "base<a, b, ...>", the name of a kernel template's instance, as a
// profiler shows it.
template <class... T>
std::string template_name(const char* base, T... args) {
  std::string s = base;
  const char* sep = "<";
  ((s += sep, s += template_arg(args), sep = ", "), ...);
  return s + ">";
}

// The current device's SMs, read once (132 where it cannot be read).
inline int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || count <= 0)
      count = 132;
  }
  return count;
}

}  // namespace
}  // namespace vitta

// "name\tcount\n" for every kernel this library has launched, in the order
// of their first launch, into buf (cap bytes, NUL-terminated where it
// fits; buf may be null where cap is 0).  Returns the length of the whole
// text, so that a caller whose buffer was short can ask again.
extern "C" int vitta_launch_counts(char* buf, int cap) {
  vitta::LaunchCounts& c = vitta::launch_counts();
  std::string text;
  {
    const std::lock_guard<std::mutex> lock(c.mu);
    for (const auto& entry : c.by_name)
      text += entry.first + "\t" + std::to_string(entry.second) + "\n";
  }
  if (buf != nullptr && cap > (int)text.size())
    text.copy(buf, text.size()), buf[text.size()] = '\0';
  return (int)text.size();
}
