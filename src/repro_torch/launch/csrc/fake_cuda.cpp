// A CUDA device guard and CUDA hooks for a build of PyTorch without CUDA,
// preloaded (LD_PRELOAD) into a process that traces fake CUDA tensors
// (torch._subclasses.FakeTensorMode) for launch/dryrun.py. Such a build has
// no CUDA device guard, so indexing a fake CUDA tensor raises, and no CUDA
// accelerator, so autograd's backward over one raises: this registers
// c10's own FakeGuardImpl for CUDA (streams and events that do nothing) and
// hooks that report a CUDA accelerator. No kernel runs, nothing is allocated
// on a device, and a build of PyTorch with CUDA never loads this file.
#include <ATen/detail/CUDAHooksInterface.h>
#include <c10/core/impl/DeviceGuardImplInterface.h>
#include <c10/core/impl/FakeGuardImpl.h>

namespace {

struct ShapeOnlyHooks final : at::CUDAHooksInterface {
  explicit ShapeOnlyHooks(at::CUDAHooksArgs) {}
  bool hasCUDA() const override { return true; }
  bool isBuilt() const override { return true; }
  bool isAvailable() const override { return true; }
  void init() const override {}
  c10::DeviceIndex deviceCount() const override { return 1; }
  c10::DeviceIndex getCurrentDevice() const override { return 0; }
  bool hasPrimaryContext(c10::DeviceIndex) const override { return true; }
};

c10::impl::FakeGuardImpl<c10::DeviceType::CUDA> fake_guard;

struct Install {
  Install() {
    auto& slot = c10::impl::device_guard_impl_registry[static_cast<size_t>(
        c10::DeviceType::CUDA)];
    if (slot.load() == nullptr) slot.store(&fake_guard);
  }
} install;

}  // namespace

namespace at {
C10_REGISTER_TYPED_CLASS(CUDAHooksRegistry, "CUDAHooks", ShapeOnlyHooks)
}

extern "C" int repro_fake_cuda_loaded() { return 1; }
