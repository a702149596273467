"""repro_torch — the PolarFly reproduction ported to PyTorch and CUDA.

A second package beside the JAX package ``repro``, which stays the
reference.  This package imports ``torch`` and numpy, never ``jax`` and
nothing of ``repro``: the host modules it needs (graph construction,
routing, traffic, path building, obs) are its own copies.

Ported so far are the paper's §VIII saturation path:

    core.polarfly.build_polarfly -> core.routing.build_routing ->
    simulation.make_pattern -> simulation.build_flow_paths ->
    simulation.saturation_throughput / evaluate_load / latency_curve

with the per-step path-cost reduction as a hand-written CUDA kernel
(``kernels/minplus/csrc/path_costs.cu``), and the structural-analysis
entry points:

    kernels.gf_crossprod.ops.intermediate_table   (§IV-D routing table,
        kernel ``kernels/gf_crossprod/csrc/crossprod.cu``)
    kernels.minplus.ops.apsp / diameter_from_adj  (§IX, kernel
        ``kernels/minplus/csrc/minplus.cu``)
    core.metrics, core.topologies, and backend="sharded" of the blocked
        routing engine (the BFS in PyTorch on the device)

the prefill and serve paths of the dense and MoE transformers and the
Griffin hybrid:

    configs.get_config -> models.build_model -> TransformerLM.forward /
        GriffinLM.forward (every attention layer on the flash-attention
        kernels ``kernels/flash_attention/csrc/flash_attention_sm90.cu``
        (bf16) and ``flash_attention.cu``)
    init_cache / decode_step -> launch.serve.generate

and the fabric cost models (``fabric.place_pod``, the collectives; host
numpy, the link rate given by the caller).

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``.

``repro_torch.analysis`` (reprolint-torch, the port's linter) is
stdlib-only, so importing this package loads no torch: `resolve_device`
comes from ``device`` on first use.
"""

__all__ = ["resolve_device"]


def __getattr__(name: str):
    if name == "resolve_device":
        from .device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
