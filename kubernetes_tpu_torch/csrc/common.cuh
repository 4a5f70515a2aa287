// Shared by every kernel library of csrc/: each .cu file includes this
// header once and is built into its own shared library, loaded by
// kernels/build.py with ctypes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

// Text for the error code an entry point returned.
extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Makes `device` the calling thread's current CUDA device for the guard's
// scope and puts the previous one back after. Every entry point takes the
// device of the tensors it is given and opens one of these first, so it
// launches on that device (and its stream and its PerDevice values)
// whatever device the thread had current. When the two already agree it
// costs one cudaGetDevice, a read of thread-local state.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    error_ = cudaGetDevice(&previous_);
    if (error_ == cudaSuccess && previous_ != device) {
      error_ = cudaSetDevice(device);
      switched_ = error_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (switched_) cudaSetDevice(previous_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;

  // cudaSuccess (0), or the error of reading or setting the device.
  int error() const { return static_cast<int>(error_); }

 private:
  int previous_ = 0;
  cudaError_t error_ = cudaSuccess;
  bool switched_ = false;
};

// Devices whose values a PerDevice keeps; one past them is asked again on
// every call.
constexpr int kMaxDevices = 64;

// A non-zero int per device, asked once and then kept. get() reads the
// calling thread's current device and, the first time for that device,
// runs query(device, &value), which returns a cudaError_t; the value is
// kept only when that is cudaSuccess. Returns a CUDA error code. Threads
// that race on a first call may each run the query, which is harmless
// for what it is used for: setting a kernel's function attributes.
class PerDevice {
 public:
  template <typename Query>
  int get(int* value, Query query) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const bool keep = device >= 0 && device < kMaxDevices;
    if (keep) {
      *value = values_[device].load(std::memory_order_relaxed);
      if (*value != 0) return 0;
    }
    err = query(device, value);
    if (err == cudaSuccess && keep) {
      values_[device].store(*value, std::memory_order_relaxed);
    }
    return static_cast<int>(err);
  }

 private:
  std::atomic<int> values_[kMaxDevices] = {};
};
