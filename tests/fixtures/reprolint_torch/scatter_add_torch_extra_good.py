"""Fixture: the quiet counterparts of scatter_add_torch_extra_bad.py."""
import torch


def writes(x, idx, w, idx2):
    a = x.index_select(0, idx)  # form: index_add
    b = torch.index_copy(x, 0, idx, w)  # form: torch_index_add
    c = x.scatter_(0, idx, w)  # form: scatter_add_
    d = torch.gather(x, 0, idx)  # form: torch_scatter_add
    e = x.scatter(0, idx, w)  # form: scatter_reduce_
    f = torch.take_along_dim(x, idx, 0)  # form: torch_scatter_reduce
    x.index_put_((idx,), w, accumulate=False)  # form: index_put_kw
    x.index_put_((idx, idx2), w)  # form: index_put_positional
    g = torch.index_put(x, (idx,), w)  # form: torch_index_put
    x.put_(idx, w)  # form: put_
    h = x.put(idx, w, False)  # form: put
    return a, b, c, d, e, f, g, h
