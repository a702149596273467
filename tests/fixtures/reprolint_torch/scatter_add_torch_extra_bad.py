"""Fixture: torch-only scatter-add forms the rule must flag; each line
marked `# form: <name>` is one case."""
import torch


def scatters(x, idx, w, idx2):
    a = x.index_add(0, idx, w)  # form: index_add
    b = torch.index_add(x, 0, idx, w)  # form: torch_index_add
    c = x.scatter_add_(0, idx, w)  # form: scatter_add_
    d = torch.scatter_add(x, 0, idx, w)  # form: torch_scatter_add
    e = x.scatter_reduce_(0, idx, w, reduce="sum")  # form: scatter_reduce_
    f = torch.scatter_reduce(x, 0, idx, w, "amax")  # form: torch_scatter_reduce
    x.index_put_((idx,), w, accumulate=True)  # form: index_put_kw
    x.index_put_((idx, idx2), w, True)  # form: index_put_positional
    g = torch.index_put(x, (idx,), w, True)  # form: torch_index_put
    x.put_(idx, w, accumulate=True)  # form: put_
    h = x.put(idx, w, True)  # form: put
    return a, b, c, d, e, f, g, h
