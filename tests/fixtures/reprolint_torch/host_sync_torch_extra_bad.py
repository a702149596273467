"""Fixture: torch-only host-sync forms the rule must flag; each line
marked `# form: <name>` is one case (in a loop body or test, a
comprehension, or a per-step function)."""
import numpy as np
import torch
import torch.nn.functional as F


def loops(xs, m, a, b, done, flag):
    out = []
    for x in xs:
        out.append(x.tolist())  # form: tolist
        out.append(x.cpu())  # form: cpu
        out.append(x.numpy())  # form: numpy
        out.append(x.to("cpu"))  # form: to_cpu
        out.append(x.to(device=torch.device("cpu")))  # form: to_device_cpu
        out.append(np.array(x))  # form: np_array
        out.append(bool(x))  # form: bool
        out.append(int(x.sum()))  # form: int_of_reduction
        y = x * 2
        out.append(float(y))  # form: float_of_local
        if x.any():  # form: if_any
            break
        out.append(torch.equal(a, b))  # form: equal
        out.append(torch.nonzero(x))  # form: torch_nonzero
        out.append(x.nonzero())  # form: nonzero_method
        out.append(torch.unique(x))  # form: unique
        out.append(torch.masked_select(x, m))  # form: masked_select
        out.append(x.masked_select(m))  # form: masked_select_method
        out.append(torch.where(m))  # form: where_one_arg
        out.append(F.one_hot(x))  # form: one_hot
        torch.cuda.synchronize()  # form: synchronize
    while not done.all():  # form: while_all
        done = done | flag
    while bool(flag):  # form: while_bool
        flag = ~flag
    return out, [t.item() for t in xs]  # form: comprehension


def cycle(state):
    assert state.any()  # form: assert_any
    return state


def train_step(model, batch):
    def inner():
        return model(batch).item()  # form: nested_in_step
    return inner()
