"""One intra-op torch thread in each test process that imports a port
test module (every test worker imports them all when it collects).

The port's tests run tiny models, which more threads do not speed up.
Under the parallel test workers every worker's thread pool contends for
the same cores: the six heaviest port test files took 455 s in six workers
with torch's default pool, 118 s with one thread a process.
"""

import torch

torch.set_num_threads(1)
