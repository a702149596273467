"""Fixture: patterns the host-sync rule must NOT flag (torch)."""
import functools

import torch


def not_in_a_loop(x):
    return x.item()  # host code outside the device loop, sync is fine


@torch.no_grad()
def shape_step(x):
    return x * float(x.shape[0])  # shape reads are host values


@functools.lru_cache(maxsize=None)
def static_step(x, scale: float):
    return x * float(scale)  # an annotated Python scalar: static, no sync


@torch.no_grad()
def suppressed_step(x):
    return int(x)  # reprolint-torch: allow[host-sync] -- fixture: pragma suppression must work


def assigned_static(xs, scale: float):
    return [x * float(scale) for x in xs]  # float() of a scalar in a loop


assigned_static_no_grad = torch.no_grad()(assigned_static)


def stepper(x):
    return float(x)  # a step-like name, but not a per-step function's
