// A fatal-signal handler that prints the native stack of a crash: the
// faulting instruction and every frame of backtrace(), each with its
// library, the offset into it and its symbol (mangled, then demangled).
//
// Built and loaded by tools/native_stack.py (ctypes, plain C interface).
// install() takes the handler that is in place (Python's faulthandler,
// when it was enabled first) as the one to chain to: after the native
// stack it is put back and the signal raised again, so faulthandler still
// prints the Python stacks and the process still dies of the signal.
//
// The frames go to stderr and, when a path is given, to that file,
// opened at install time. Each line is written with write(2): a crash in
// malloc does not lose them. Symbols come from dladdr (exported symbols
// only); the library offset is what addr2line or gdb take.

#include <cxxabi.h>
#include <dlfcn.h>
#include <execinfo.h>
#include <fcntl.h>
#include <signal.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/syscall.h>
#include <ucontext.h>
#include <unistd.h>

namespace {

const int kSignals[] = {SIGSEGV, SIGABRT, SIGBUS, SIGILL, SIGFPE};
constexpr int kMaxFrames = 128;

int log_fd = -1;
struct sigaction previous[NSIG];
volatile sig_atomic_t entered = 0;
char alt_stack[1 << 16];

void put(const char* text) {
  size_t n = strlen(text);
  ssize_t unused = write(2, text, n);
  if (log_fd >= 0) unused = write(log_fd, text, n);
  (void)unused;
}

void frame(int index, void* pc, bool demangle) {
  char line[1536];
  Dl_info info;
  if (dladdr(pc, &info) == 0 || info.dli_fname == nullptr) {
    snprintf(line, sizeof line, "#%-3d %p ?\n", index, pc);
    put(line);
    return;
  }
  const char* name = info.dli_sname ? info.dli_sname : "?";
  char* readable = nullptr;
  int status = -1;
  if (demangle && info.dli_sname)
    readable = abi::__cxa_demangle(info.dli_sname, nullptr, nullptr, &status);
  unsigned long offset = (unsigned long)((char*)pc - (char*)info.dli_fbase);
  unsigned long into = info.dli_saddr
      ? (unsigned long)((char*)pc - (char*)info.dli_saddr) : 0UL;
  snprintf(line, sizeof line, "#%-3d %p %s+0x%lx %s+0x%lx\n", index, pc,
           info.dli_fname, offset, status == 0 ? readable : name, into);
  free(readable);
  put(line);
}

void* fault_pc(void* context) {
  const ucontext_t* uc = static_cast<const ucontext_t*>(context);
#if defined(__x86_64__)
  return (void*)uc->uc_mcontext.gregs[REG_RIP];
#elif defined(__aarch64__)
  return (void*)uc->uc_mcontext.pc;
#else
  (void)uc;
  return nullptr;
#endif
}

void handler(int sig, siginfo_t* info, void* context) {
  if (entered) {  // a fault inside this handler: die of it at once
    signal(sig, SIG_DFL);
    raise(sig);
    return;
  }
  entered = 1;
  char line[256];
  snprintf(line, sizeof line,
           "\nnative stack: signal %d (%s), fault address %p, thread %ld\n",
           sig, strsignal(sig), info ? info->si_addr : nullptr,
           (long)syscall(SYS_gettid));
  put(line);
  put("faulting instruction:\n");
  frame(0, fault_pc(context), true);
  void* frames[kMaxFrames];
  int n = backtrace(frames, kMaxFrames);
  put("backtrace, mangled:\n");
  for (int i = 0; i < n; ++i) frame(i, frames[i], false);
  put("backtrace, demangled:\n");
  for (int i = 0; i < n; ++i) frame(i, frames[i], true);
  put("native stack: end\n");
  if (log_fd >= 0) fsync(log_fd);
  // chain: the handler before this one (faulthandler's), else the default
  sigaction(sig, &previous[sig], nullptr);
  raise(sig);
}

}  // namespace

extern "C" {

// Install the handler for SIGSEGV, SIGABRT, SIGBUS, SIGILL and SIGFPE on an
// alternate stack; ``path`` (may be NULL or empty) also receives the
// frames. Returns 0, or -1 when sigaction fails.
int ruart_native_stack_install(const char* path) {
  void* warm[2];
  backtrace(warm, 2);  // loads libgcc's unwinder now, not inside a crash
  if (path != nullptr && path[0] != '\0')
    log_fd = open(path, O_WRONLY | O_CREAT | O_TRUNC | O_CLOEXEC, 0644);
  stack_t ss = {};
  ss.ss_sp = alt_stack;
  ss.ss_size = sizeof alt_stack;
  if (sigaltstack(&ss, nullptr) != 0) return -1;
  struct sigaction sa = {};
  sa.sa_sigaction = handler;
  sa.sa_flags = SA_SIGINFO | SA_ONSTACK | SA_NODEFER;
  sigemptyset(&sa.sa_mask);
  for (int sig : kSignals)
    if (sigaction(sig, &sa, &previous[sig]) != 0) return -1;
  return 0;
}

// 1 when every signal of the set still goes to this handler (a library
// loaded later may have installed its own), else 0.
int ruart_native_stack_active(void) {
  for (int sig : kSignals) {
    struct sigaction now;
    if (sigaction(sig, nullptr, &now) != 0 || now.sa_sigaction != handler)
      return 0;
  }
  return 1;
}

}  // extern "C"
