"""Fixture: the quiet counterparts of compat_shim_torch_extra_bad.py."""
import logging

import torch
import torch.distributed  # form: private_module_import
import torch.nn.functional as F
from torch.autograd import profiler as _prof
from torch.distributed import tensor  # form: private_name_import
from torch.distributed.tensor import DTensor  # form: old_dtensor_home
from torch.distributed.distributed_c10d import get_world_size  # form: private_function_import
from ..parallel.compat import local_map  # form: experimental_module_import
from torch.testing import assert_close  # form: testing_internal


def uses(x, obj):
    on = _prof.record_function  # form: private_through_alias
    torch.cuda.synchronize()  # form: private_cuda
    v = torch.__version__  # form: memory_history
    m = F.scaled_dot_product_attention  # form: private_through_module_alias
    logging.getLogger("torch.distributed.tensor._redistribute")  # form: torch_c
    return on, v, m, obj._private, tensor, DTensor, get_world_size, local_map, assert_close, x
