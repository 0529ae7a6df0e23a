// The kernel instance a library launched last, as the profiler spells it
// without namespace and parameters ("matmul_bn_sm90_kernel<64, true>").
// Each launch site writes it (note_launch) before it launches; an entry
// .cu exports it as <name>_last_kernel() (ZOO_EXPORT_LAST_KERNEL), which
// `last_kernel` in ops/conv_bn.py and ops/flash_attention.py reads. The
// card tests check a route by it beside their torch.profiler window, so
// a route check does not rest on the profiler alone.
//
// The record is per library and per host thread: it has internal linkage
// (an unnamed namespace), so two libraries in one process never share it
// (a function-local static of an inline function would be one
// GNU-unique symbol across every library loaded).

#pragma once

#include <cuda_bf16.h>

#include <cstdio>

namespace zoo {
namespace {

thread_local char last_kernel_name[160] = "";

template <typename T>
constexpr const char* type_name();
template <>
constexpr const char* type_name<float>() { return "float"; }
template <>
constexpr const char* type_name<__nv_bfloat16>() { return "__nv_bfloat16"; }

constexpr const char* bool_name(bool b) { return b ? "true" : "false"; }

// printf-style: the instance's name with its template arguments.
template <typename... A>
void note_launch(const char* fmt, A... args) {
  snprintf(last_kernel_name, sizeof(last_kernel_name), fmt, args...);
}

}  // namespace
}  // namespace zoo

#define ZOO_EXPORT_LAST_KERNEL(lib)                  \
  extern "C" const char* lib##_last_kernel() {       \
    return zoo::last_kernel_name;                    \
  }
