"""Fixture: torch-only compat-shim forms the rule must flag; each line
marked `# form: <name>` is one case."""
import torch
import torch._dynamo  # form: private_module_import
import torch.nn.functional as F
from torch.autograd import profiler as prof
from torch.distributed import _tensor  # form: private_name_import
from torch.distributed._tensor import DTensor  # form: old_dtensor_home
from torch.distributed.distributed_c10d import _resolve_process_group  # form: private_function_import
from torch.distributed.tensor import experimental  # form: experimental_module_import
from torch.testing._internal.distributed.fake_pg import FakeStore  # form: testing_internal


def uses(x):
    on = prof._is_profiler_enabled  # form: private_through_alias
    torch.cuda._sleep(1000)  # form: private_cuda
    torch.cuda.memory._record_memory_history()  # form: memory_history
    m = F._canonical_mask  # form: private_through_module_alias
    n = torch._C._current_autograd_node()  # form: torch_c
    return on, m, n, _tensor, DTensor, _resolve_process_group, experimental, FakeStore, x
