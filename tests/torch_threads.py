"""One torch intra-op thread for each process that runs the port's tests.

The tier-1 command runs six pytest workers on the machine's cores, JAX's
XLA pools beside them. torch's default pool, one thread per core in each
worker, then oversubscribes the cores: its threads spin at every
parallel region of the tiny models' ops, and a test that takes half a
second alone took up to sixty times as long in the suite. Every port
test file imports this module, so whichever file a worker collects
first sets it for all of that worker's tests.
"""

import torch

torch.set_num_threads(1)
