"""Quickstart on the card: GENESYS device-initiated syscalls in the PyTorch
port, in 40 lines.

A step on the GPU reads its own input file through a GENESYS pread
(relaxed-consumer, blocking): a CUDA kernel posts the call's slot into
mapped host memory, the host plane answers it, and the step's output waits
for the answer on the card (paper Fig 1 right). Needs a CUDA card.

  PYTHONPATH=src python examples/torch_quickstart.py
"""
import os
import tempfile

import numpy as np
import torch

from repro_torch.core.genesys import (Genesys, GenesysConfig, Granularity,
                                      Ordering, Sys)
from repro_torch.core.genesys.invoke import pack_args

g = Genesys(GenesysConfig(n_workers=2, coalesce_window_us=100,
                          coalesce_max=8))

# a data file the device will read *from inside the step*
path = tempfile.mktemp()
np.arange(256, dtype=np.float32).tofile(path)
ph = g.heap.register_bytes(path.encode())
fd = g.call(Sys.OPEN, ph, os.O_RDONLY, 0)
buf = g.heap.new_buffer(1024)


def step(x):
    # device -> host syscall: one work-group-granularity pread
    res = g.invoke(Sys.PREAD64, pack_args(fd, buf, 1024, 0, device=x.device),
                   granularity=Granularity.WORK_GROUP,
                   ordering=Ordering.RELAXED_CONSUMER, blocking=True,
                   deps=x)
    return res.tie(x * 2.0), res.ret64()


y, nread = step(torch.ones(4, device="cuda"))
data = np.asarray(g.heap.resolve(buf)).view(np.float32)
print(f"pread returned {int(nread)} bytes from inside the step on "
      f"{torch.cuda.get_device_name(0)}")
print(f"first values: {data[:4]}  (expected 0,1,2,3)")
print(f"step result: {y.cpu()}")
print(f"executor stats: {g.executor.stats.processed} syscalls processed")
g.call(Sys.CLOSE, fd)
g.shutdown()
os.unlink(path)
