// nvml_probe — enumerates the host's NVIDIA GPUs through NVML.
//
// Counterpart of kubernetes_tpu/native/libtpu_probe.cpp, and the analog
// of the reference's gonvml shim (vendor/github.com/mindprince/gonvml/
// bindings.go:19-30): it dlopen()s libnvidia-ml.so.1 and binds the few
// query functions it calls behind function pointers, so nothing links
// the driver. It declares those prototypes itself and needs no CUDA
// toolkit to build: g++ -O2 -std=c++17 nvml_probe.cpp -ldl.
//
// NVML is a side-channel query library: it creates no CUDA context and
// takes no memory on a card. The probe still runs as a short-lived
// subprocess of the device plugin, so a fault in the driver stays out
// of the plugin process.
//
// Run: nvml_probe [path/to/libnvidia-ml.so]. An argv[1] is
// authoritative: a caller that names a library wants that one, with no
// fallback to the soname.
//
// Output, one JSON line on stdout, exit 0 (the contract of the device
// plugin's probes, deviceplugin/gpu_plugin.py):
//   {"gpu": true, "source": "nvml_probe", "process_index": 0,
//    "devices": [{"index": i, "kind": name, "uuid": "GPU-...",
//                 "coords": [i, 0, 0], "minor_number": m,
//                 "memory": {"hbm_used_bytes": u, "hbm_total_bytes": t}}]}
//   {"gpu": false, "error": "...", "source": "nvml_probe"} when there
//   is no library, no driver or no device.
// "minor_number" (the N of /dev/nvidiaN) appears where the library
// has nvmlDeviceGetMinorNumber.

#include <dlfcn.h>
#include <unistd.h>

#include <csignal>
#include <cstdio>
#include <cstdlib>
#include <string>

namespace {

// The NVML declarations the probe uses (nvml.h, NVML API v2 names).
typedef struct nvmlDevice_st* nvmlDevice_t;
struct nvmlMemory_t {
  unsigned long long total;
  unsigned long long free;
  unsigned long long used;
};
typedef int (*InitFn)();
typedef int (*ShutdownFn)();
typedef int (*GetCountFn)(unsigned int*);
typedef int (*GetHandleFn)(unsigned int, nvmlDevice_t*);
typedef int (*GetStringFn)(nvmlDevice_t, char*, unsigned int);
typedef int (*GetMemoryFn)(nvmlDevice_t, nvmlMemory_t*);
typedef int (*GetMinorFn)(nvmlDevice_t, unsigned int*);
typedef const char* (*ErrorStringFn)(int);
constexpr unsigned int kStringLen = 96;  // NVML's longest name / UUID

std::string jesc(const std::string& s) {
  std::string out;
  for (char c : s) {
    if (c == '"' || c == '\\') {
      out += '\\';
      out += c;
    } else if (static_cast<unsigned char>(c) < 0x20) {
      char buf[8];
      std::snprintf(buf, sizeof buf, "\\u%04x", c);
      out += buf;
    } else {
      out += c;
    }
  }
  return out;
}

// Set once the verdict is on stdout: a late watchdog then exits quietly
// instead of printing a second, contrary line.
volatile std::sig_atomic_t answered = 0;

// "No GPU" is an answer, not a failure: print it and exit 0. A non-zero
// exit or garbage on stdout is what the caller treats as a crashed
// probe.
[[noreturn]] void no_gpu(const std::string& why) {
  std::printf("{\"gpu\": false, \"error\": \"%s\", \"source\": \"nvml_probe\"}\n",
              jesc(why).c_str());
  std::fflush(stdout);
  std::exit(0);
}

// The probe always terminates with a verdict: a driver that never
// answers nvmlInit (a wedged card, a held lock) is no GPU, said within
// the watchdog's time. Async-signal-safe: write and _exit only.
extern "C" void watchdog_fire(int) {
  if (!answered) {
    static const char msg[] =
        "{\"gpu\": false, \"error\": \"watchdog: NVML did not answer in "
        "time\", \"source\": \"nvml_probe\"}\n";
    ssize_t n = write(STDOUT_FILENO, msg, sizeof msg - 1);
    (void)n;
  }
  _exit(0);
}

std::string nvml_error(ErrorStringFn err_str, int rc) {
  const char* s = err_str != nullptr ? err_str(rc) : nullptr;
  return s != nullptr ? std::string(s) : "NVML error " + std::to_string(rc);
}

}  // namespace

int main(int argc, char** argv) {
  // NVML_PROBE_TIMEOUT_S overrides the watchdog's seconds.
  unsigned watchdog_s = 30;
  if (const char* w = std::getenv("NVML_PROBE_TIMEOUT_S")) {
    long v = std::strtol(w, nullptr, 10);
    if (v > 0) watchdog_s = static_cast<unsigned>(v);
  }
  std::signal(SIGALRM, watchdog_fire);
  alarm(watchdog_s);

  const std::string lib = argc > 1 ? argv[1] : "libnvidia-ml.so.1";
  void* handle = lib.empty() ? nullptr : dlopen(lib.c_str(), RTLD_NOW | RTLD_LOCAL);
  if (handle == nullptr) {
    const char* e = dlerror();
    no_gpu("dlopen " + lib + " failed: " + (e != nullptr ? e : "empty path"));
  }
  auto init = reinterpret_cast<InitFn>(dlsym(handle, "nvmlInit_v2"));
  auto shutdown = reinterpret_cast<ShutdownFn>(dlsym(handle, "nvmlShutdown"));
  auto get_count = reinterpret_cast<GetCountFn>(dlsym(handle, "nvmlDeviceGetCount_v2"));
  auto get_handle =
      reinterpret_cast<GetHandleFn>(dlsym(handle, "nvmlDeviceGetHandleByIndex_v2"));
  auto get_name = reinterpret_cast<GetStringFn>(dlsym(handle, "nvmlDeviceGetName"));
  auto get_uuid = reinterpret_cast<GetStringFn>(dlsym(handle, "nvmlDeviceGetUUID"));
  auto get_memory =
      reinterpret_cast<GetMemoryFn>(dlsym(handle, "nvmlDeviceGetMemoryInfo"));
  auto get_minor =
      reinterpret_cast<GetMinorFn>(dlsym(handle, "nvmlDeviceGetMinorNumber"));
  auto err_str = reinterpret_cast<ErrorStringFn>(dlsym(handle, "nvmlErrorString"));
  if (!init || !shutdown || !get_count || !get_handle || !get_name ||
      !get_uuid || !get_memory) {
    no_gpu(lib + " lacks the NVML functions the probe calls");
  }

  int rc = init();
  if (rc != 0) no_gpu("nvmlInit_v2: " + nvml_error(err_str, rc));
  unsigned int count = 0;
  rc = get_count(&count);
  if (rc != 0) no_gpu("nvmlDeviceGetCount_v2: " + nvml_error(err_str, rc));
  if (count == 0) no_gpu("NVML reports no device");

  std::string devices;
  for (unsigned int i = 0; i < count; ++i) {
    nvmlDevice_t dev = nullptr;
    rc = get_handle(i, &dev);
    if (rc != 0) {
      no_gpu("nvmlDeviceGetHandleByIndex_v2(" + std::to_string(i) +
             "): " + nvml_error(err_str, rc));
    }
    char name[kStringLen] = {0};
    char uuid[kStringLen] = {0};
    nvmlMemory_t mem = {0, 0, 0};
    if ((rc = get_name(dev, name, kStringLen)) != 0 ||
        (rc = get_uuid(dev, uuid, kStringLen)) != 0 ||
        (rc = get_memory(dev, &mem)) != 0) {
      no_gpu("device " + std::to_string(i) + ": " + nvml_error(err_str, rc));
    }
    std::string minor;
    unsigned int m = 0;
    if (get_minor != nullptr && get_minor(dev, &m) == 0) {
      minor = ", \"minor_number\": " + std::to_string(m);
    }
    const std::string idx = std::to_string(i);
    if (!devices.empty()) devices += ", ";
    devices += "{\"index\": " + idx + ", \"kind\": \"" + jesc(name) +
               "\", \"uuid\": \"" + jesc(uuid) + "\", \"coords\": [" + idx +
               ", 0, 0]" + minor + ", \"memory\": {\"hbm_used_bytes\": " +
               std::to_string(mem.used) +
               ", \"hbm_total_bytes\": " + std::to_string(mem.total) + "}}";
  }
  alarm(0);
  std::printf(
      "{\"gpu\": true, \"source\": \"nvml_probe\", \"process_index\": 0, "
      "\"devices\": [%s]}\n",
      devices.c_str());
  std::fflush(stdout);
  answered = 1;
  // Past the verdict a hang costs the caller only its own timeout; the
  // watchdog guards the shutdown too.
  alarm(watchdog_s);
  shutdown();
  return 0;
}
