"""Fixture: the quiet counterparts of host_sync_torch_extra_bad.py (host
values, code outside the device loop, and the exemptions)."""
import numpy as np
import torch
import torch.nn.functional as F


def _host(t):
    return t.detach().cpu().numpy()


def loops(xs, m, a, b, n: int, rng: np.random.Generator):
    arr = np.arange(n)
    flags = [False] * n
    last = xs[-1].cpu()  # form: cpu
    first = xs[0].numpy()  # form: numpy
    out = [last, first, torch.equal(a, b)]  # form: equal
    out.append(torch.nonzero(m))  # form: torch_nonzero
    out.append(torch.unique(m))  # form: unique
    out.append(torch.masked_select(a, m))  # form: masked_select
    torch.cuda.synchronize()  # form: synchronize
    for i in range(n):
        out.append(arr.tolist())  # form: tolist
        out.append(xs[i].to("cuda"))  # form: to_cpu
        out.append(xs[i].to(device=torch.device("cuda")))  # form: to_device_cpu
        out.append(np.array([i, i + 1]))  # form: np_array
        out.append(bool(i > 2))  # form: bool
        out.append(int(xs[i].shape[0]) + int(xs[i].numel()))  # form: int_of_reduction
        out.append(float(int(rng.integers(5))))  # form: float_of_local
        if arr.any():  # form: if_any
            break
        out.append(arr.nonzero())  # form: nonzero_method
        out.append(a.masked_fill(m, 0))  # form: masked_select_method
        out.append(torch.where(m, a, b))  # form: where_one_arg
        out.append(F.one_hot(xs[i], num_classes=8))  # form: one_hot
        for v in _host(xs[i]):
            out.append(float(v))
    while not all(flags):  # form: while_all
        flags = [True] * n
    while bool(n > len(out)):  # form: while_bool
        out.append(None)
    return out, [len(t) for t in xs]  # form: comprehension


def cycle(state):
    assert state.shape[0] > 0  # form: assert_any
    return state


def train_loop(model, batch):
    for t in batch:
        def later():
            return t.item()  # a nested def starts outside the loop
        out = model(t)
    return out, later


def fw_step_reference(x):
    return x.item()  # form: nested_in_step


class _Run:
    def run(self):
        for t in range(self.cycles):
            self.cycle(t, int(t >= self.switch))

    def cycle(self, t: int, ep: int) -> None:
        self.queue = self.queue + t + ep
