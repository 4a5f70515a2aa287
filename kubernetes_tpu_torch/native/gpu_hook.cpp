// gpu_hook — container runtime hook that hands a container its GPUs.
//
// Counterpart of kubernetes_tpu/native/tpu_hook.cpp, and the analog of
// the NVIDIA Container Runtime that the reference selects through
// docker hooks (pkg/kubelet/dockershim/docker_hooks.go:139-160): a
// native pre-start step that injects device nodes into a container.
// It injects exactly the GPUs the scheduler picked, and the driver's
// control nodes. A GPU's node is /dev/nvidia<minor>, numbered by its
// minor number, which need not be NVML's index (the <N> of
// chip gpu-<N>): node/runtimehook.py resolves each chip's minor number
// through NVML, as the NVIDIA runtime does, and passes it in.
//
// Protocol (line-based, no JSON, so the binary has no dependencies):
//   stdin:   chip <chip-id> <minor> (one per assigned chip; may be none;
//                                   a chip without its minor number has
//                                   no node)
//            allow-missing         (dev boxes: no devices is not fatal)
//            dev-root <path>       (tests: scan here instead of /dev)
//   stdout:  device <path>         (each assigned GPU's node, in chip
//                                   order, then nvidiactl, nvidia-uvm and
//                                   nvidia-uvm-tools where present)
//            env GPU_RUNTIME_HOOK=native   (when any device is injected)
//   exit 0 = ok; exit 1 = chips were assigned but an assigned GPU's node
//   or /dev/nvidiactl is missing (no device access).
//
// Built at first use by kubernetes_tpu_torch/native/__init__.py (g++
// -O2). node/runtimehook.py holds the same discovery in Python, the
// semantic source of truth the tests hold this binary to.

#include <sys/stat.h>

#include <cstdio>
#include <string>
#include <vector>

static bool exists(const std::string& p) {
  struct stat st;
  return ::stat(p.c_str(), &st) == 0;
}

// The minor number of "<chip-id> <minor>", or -1 where it is missing
// or not a number.
static long minor_of(const std::string& arg) {
  const size_t sp = arg.find(' ');
  if (sp == std::string::npos || sp + 1 == arg.size()) return -1;
  long n = 0;
  for (size_t i = sp + 1; i < arg.size(); ++i) {
    if (arg[i] < '0' || arg[i] > '9' || n > 1000000) return -1;
    n = n * 10 + (arg[i] - '0');
  }
  return n;
}

int main() {
  std::vector<std::string> chips;  // "<chip-id> <minor>" or "<chip-id>"
  bool allow_missing = false;
  std::string dev_root = "/dev";

  char line[4096];
  while (fgets(line, sizeof line, stdin) != nullptr) {
    std::string s(line);
    while (!s.empty() && (s.back() == '\n' || s.back() == '\r')) s.pop_back();
    if (s.rfind("chip ", 0) == 0) {
      chips.push_back(s.substr(5));
    } else if (s == "allow-missing") {
      allow_missing = true;
    } else if (s.rfind("dev-root ", 0) == 0) {
      dev_root = s.substr(9);
    }
  }

  std::vector<std::string> devices;
  std::vector<std::string> missing;
  for (const std::string& chip : chips) {
    const long n = minor_of(chip);
    const std::string node =
        n < 0 ? "" : dev_root + "/nvidia" + std::to_string(n);
    bool seen = false;
    for (const std::string& d : devices) seen = seen || d == node;
    if (n >= 0 && exists(node)) {
      if (!seen) devices.push_back(node);
    } else {
      missing.push_back(chip.substr(0, chip.find(' ')));
    }
  }
  const bool have_ctl = exists(dev_root + "/nvidiactl");
  if (!chips.empty() && (!missing.empty() || !have_ctl) && !allow_missing) {
    fprintf(stderr,
            "gpu_hook: container assigned %zu chip(s) but %s under %s\n",
            chips.size(),
            missing.empty() ? "no nvidiactl"
                            : ("no device node for " + missing[0]).c_str(),
            dev_root.c_str());
    return 1;
  }
  for (const char* ctl : {"nvidiactl", "nvidia-uvm", "nvidia-uvm-tools"}) {
    const std::string p = dev_root + "/" + ctl;
    if (exists(p)) devices.push_back(p);
  }
  for (const std::string& dev : devices) printf("device %s\n", dev.c_str());
  if (!devices.empty()) printf("env GPU_RUNTIME_HOOK=native\n");
  return 0;
}
