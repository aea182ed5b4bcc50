"""Machine-readable reproduction of the paper's appendix: the viability of
each x86_64 Linux system call when invoked from an accelerator (paper §8.1 +
Table 4), with the paper's footnote classes:

  *      signals can be delivered only to CPU threads
  **     mostly serializing use, little benefit for accelerator workloads
  ***    targets threads; no OS kernel structure represents accelerator tasks
  ****   postponing return from the call has the desired effect
  *****  implementable without a syscall / accelerator-modified semantics

Groups (paper Fig 11): ~79% useful & implementable, ~13% useful but not
currently implementable, ~8% not useful.
"""
from __future__ import annotations

_RAW = """
accept:yes; accept4:yes; access:yes; acct:yes; add_key:yes; adjtimex:yes;
alarm:yes, limited use*; arch_prctl:yes; bind:yes; bpf:yes;
brk:yes, limited use**; capget:no, targets threads***;
capset:no, targets threads***; chdir:yes; chmod:yes; chown:yes; chroot:yes;
clock_adjtime:yes; clock_getres:yes; clock_gettime:yes;
clock_nanosleep:yes****; clock_settime:yes; clone:yes; close:yes;
connect:yes; copy_file_range:yes; creat:yes; delete_module:yes; dup:yes;
dup2:yes; dup3:yes; epoll_create:yes; epoll_create1:yes; epoll_ctl:yes;
epoll_pwait:yes*; epoll_wait:yes; eventfd:yes; eventfd2:yes;
execveat:yes, limited use**; execve:yes, limited use**; exit:yes****;
exit_group:yes; faccessat:yes; fadvise64:yes; fallocate:yes;
fanotify_init:yes; fanotify_mark:yes; fchdir:yes; fchmod:yes; fchmodat:yes;
fchown:yes; fchownat:yes; fcntl:yes; fdatasync:yes; fgetxattr:yes;
finit_module:yes; flistxattr:yes; flock:yes, exclusive is limited**;
fork:no; fremovexattr:yes; fsetxattr:yes; fstatfs:yes; fsync:yes;
ftruncate:yes; futex:yes****; futimesat:yes; getcpu:yes****; getcwd:yes;
getdents:yes; getdents64:yes; getegid:yes; geteuid:yes; getgid:yes;
getgroups:yes; getitimer:yes; get_mempolicy:yes, address mode only;
getpeername:yes; getpgid:yes; getpgrp:yes; getpid:yes; getppid:yes;
getpriority:yes****; getrandom:yes; getresgid:yes; getresuid:yes;
getrlimit:yes; get_robust_list:no; getrusage:yes, process level only;
getsid:yes; getsockname:yes; getsockopt:yes; gettid:yes*****;
gettimeofday:yes; getuid:yes; getxattr:yes; init_module:yes;
inotify_add_watch:yes; inotify_init:yes; inotify_init1:yes;
inotify_rm_watch:yes; io_cancel:yes; ioctl:depends; io_destroy:yes;
io_getevents:yes; ioperm:no***; iopl:yes; ioprio_get:yes, CPU threads only;
ioprio_set:yes, CPU threads only; io_setup:yes; io_submit:yes; kcmp:yes;
kexec_file_load:yes; kexec_load:yes; keyctl:yes; kill:yes*; lchown:yes;
lgetxattr:yes; link:yes; linkat:yes; listen:yes; listxattr:yes;
llistxattr:yes; lookup_dcookie:yes; lremovexattr:yes; lseek:yes;
lsetxattr:yes; madvise:yes; mbind:yes; membarrier:no; memfd_create:yes;
migrate_pages:yes; mincore:yes; mkdir:yes; mkdirat:yes; mknod:yes;
mknodat:yes; mlock:yes; mlock2:yes; mlockall:yes; mmap:yes; modify_ldt:yes;
mount:yes; move_pages:yes; mprotect:yes; mq_getsetattr:yes; mq_notify:yes*;
mq_open:yes; mq_timedreceive:yes; mq_timedsend:yes; mq_unlink:yes;
mremap:yes; msgctl:yes; msgget:yes; msgrcv:yes; msgsnd:yes; msync:yes;
munlock:yes; munlockall:yes; munmap:yes; name_to_handle_at:yes;
nanosleep:yes****; newfstat:yes; newfstatat:yes; newlstat:yes; newstat:yes;
open:yes; openat:yes; open_by_handle_at:yes; pause:no;
perf_event_open:yes, CPU perf events only; personality:yes; pipe:yes;
pipe2:yes; pivot_root:yes, limited use**; pkey_alloc:yes; pkey_free:yes;
pkey_get:yes; pkey_mprotect:yes; pkey_set:yes; poll:yes; ppoll:yes*;
prctl:yes; pread64:yes; preadv:yes; preadv2:yes; preadv64:yes;
preadv64v2:yes; prlimit64:yes; process_vm_readv:yes; process_vm_writev:yes;
pselect6:yes*; ptrace:yes**; pwrite64:yes; pwritev:yes; pwritev2:yes;
pwritev64:yes; pwritev64v2:yes; quotactl:yes**; read:yes; readahead:yes;
readlink:yes; readlinkat:yes; readv:yes; reboot:yes**; recvfrom:yes;
recvmmsg:yes; recvmsg:yes; remap_file_pages:yes; removexattr:yes;
rename:yes; renameat:yes; renameat2:yes; request_key:yes;
restart_syscall:yes, no use*; rmdir:yes; rt_sigaction:yes*;
rt_sigpending:yes*; rt_sigprocmask:yes*; rt_sigqueueinfo:yes, no use*;
rt_sigreturn:yes, no use*; rt_sigsuspend:yes, no use*;
rt_sigtimedwait:yes, no use*; rt_tgsigqueueinfo:yes, no use*;
sched_getaffinity:yes, CPU threads only; sched_getattr:yes, CPU threads only;
sched_getparam:yes, CPU threads only; sched_get_priority_max:yes*****;
sched_get_priority_min:yes*****; sched_getscheduler:yes, CPU threads only;
sched_rr_get_interval:yes, CPU threads only;
sched_setaffinity:yes, CPU threads only; sched_setattr:yes, CPU threads only;
sched_setparam:yes, CPU threads only;
sched_setscheduler:yes, CPU threads only; sched_yield:no; seccomp:no;
select:yes; semctl:yes; semget:yes; semop:yes; semtimedop:yes;
sendfile64:yes; sendmmsg:yes; sendmsg:yes; sendto:yes;
setdomainname:yes**; setfsgid:yes; setfsuid:yes; setgid:yes;
setgroups:yes; sethostname:yes**; setitimer:yes*; set_mempolicy:no;
setns:no; setpgid:yes; setpriority:yes****; setregid:yes; setresgid:yes;
setresuid:yes; setreuid:yes; setrlimit:yes; set_robust_list:no; setsid:yes;
setsockopt:yes; set_tid_address:no; settimeofday:yes; setuid:yes;
setxattr:yes; shmat:yes; shmctl:yes; shmdt:yes; shmget:yes; shutdown:yes**;
sigaltstack:no; signalfd:yes; signalfd4:yes; socket:yes; socketpair:yes;
splice:yes; statfs:yes; swapoff:yes**; swapon:yes**; symlink:yes;
symlinkat:yes; sync:yes**; sync_file_range:yes; syncfs:yes**; sysctl:yes**;
sysfs:yes**; sysinfo:yes; syslog:yes**; tee:yes; tgkill:yes*; time:yes;
timer_create:yes*; timer_delete:yes; timer_getoverrun:yes;
timer_gettime:yes; timer_settime:yes; timerfd_create:yes;
timerfd_gettime:yes; timerfd_settime:yes; times:yes, CPU times only;
tkill:yes*; truncate:yes; umask:yes; umount:yes**; unlink:yes;
unlinkat:yes; unshare:yes; userfaultfd:yes; ustat:yes; utime:yes;
utimensat:yes; utimes:yes; vfork:no; vhangup:yes; vmsplice:yes; wait4:yes;
waitid:yes; write:yes; writev:yes
"""


def viability() -> dict[str, str]:
    """name -> paper verdict string (e.g. 'yes', 'no', 'yes, CPU threads only')."""
    out: dict[str, str] = {}
    for ent in _RAW.replace("\n", " ").split(";"):
        ent = ent.strip()
        if not ent:
            continue
        name, verdict = ent.split(":", 1)
        out[name.strip()] = verdict.strip()
    return out


def classify(verdict: str) -> str:
    """Collapse a verdict to the paper's Fig-11 groups using the footnote
    semantics: '*' (signals only reach CPU threads) and '***' (no kernel
    representation of accelerator tasks) mark calls that are useful but not
    implementable today; '**' (serializing) / '****' (postponed return) /
    '*****' (modified semantics) remain implementable."""
    v = verdict.lower().strip()
    if v.startswith("no"):
        return "not_useful_or_unimplementable"
    stars = len(v) - len(v.rstrip("*"))
    if stars in (1, 3) or "no use" in v or "cpu threads only" in v \
            or "cpu perf events" in v or "cpu times" in v:
        return "useful_not_implementable"
    return "useful_implementable"


def summary() -> dict[str, float]:
    vi = viability()
    groups: dict[str, int] = {}
    for verdict in vi.values():
        g = classify(verdict)
        groups[g] = groups.get(g, 0) + 1
    n = len(vi)
    return {g: c / n for g, c in groups.items()} | {"total": n}
