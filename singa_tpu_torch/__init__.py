"""singa_tpu_torch: the PyTorch/CUDA port of singa_tpu, for NVIDIA Hopper.

The JAX package `singa_tpu` stays the reference; this package keeps its
module names so each counterpart is easy to find. It imports `torch` and
never `jax` or `singa_tpu`.

What is ported so far:

    the SINGA training API: device.Device, tensor.Tensor and its module
        functions, initializer, the autograd tape operators, layer.Layer
        with deferred init (Linear, Conv2d, BatchNorm2d, the pools, ...),
        model.Model.compile / __call__, opt, and the model zoo
        (models.create_model: mlp, cnn, alexnet, resnet18-152,
        xceptionnet, gpt)
    the buffered graph: compile(use_graph=True) captures each train and
        eval step as a CUDA graph; Model.fit over data.NumpyBatchIter or
        io.RecordReader-backed datasets with overlap.DevicePrefetcher;
        save_checkpoint (async, overlap) / load_checkpoint; io's record
        files and snapshot.Snapshot over the g++-built native/ sources
    models.transformer.GPT.generate -> serving.build_decode
        (build_spec_decode with a draft model) -> serving._DecodeCore
        .prefill / token_step / verify_step, in fp32, bf16 or int8
        weights and fp, int8 or int4 KV caches
    models.transformer.GPT.generate_beam -> serving.build_beam_decode
    engine.ServingEngine.submit/start/stop
        -> serving._DecodeCore.prefill_parts / paged_token_step /
        paged_verify_step
    MoE-GPT (GPT(moe_experts=...)): layer.MoE over parallel.moe.moe_ffn
        (top-k routing with capacity, dispatch by index) in training and
        in every decode path above
    the recurrences: ops.rnn (lstm_scan, lstm_scan_ex, reverse_padded,
        gru_scan) and layer.RNN, LSTM, CudnnRNN / FusedRNN
    models.transformer.load_gpt2_weights (GPT-2-convention state dicts)
    sonnx: ONNX export of a forward traced on the tape (the GPT included:
        GPT.forward on a Tensor in training mode records it), import into
        a runnable, retrainable graph (SONNXModel), the self-contained
        protobuf codec, and torch's TorchScript exporter without the
        `onnx` package (sonnx.interop); utils (SAME padding, the tape's
        postorder walk)
    observe (metrics, spans); slo (request timelines, SLO burn rates,
        tail attribution, the request trace); health (step stats on the
        device, warn / skip_step / halt, the flight recorder, the
        non-finite logit watch); resilience's fault injection (FaultPlan)
    multi-replica serving: router.Router over ReplicaControl'd engines in
        replica processes (spawn_replica, the kill-and-replace --ab),
        fleet's ShardWriter / FleetAggregator (straggler scores, the merged
        trace, the straggler --ab) and diag's live HTTP endpoints;
        capacity (per-replica headroom, the demand forecast, the shadow
        autoscaler's ledger) and audit (parameter fingerprints, canary
        probes, shadow replays, quarantine by drain)
    data parallelism: distributed (one process per rank over
        torch.distributed: NCCL on the card, gloo on the CPU),
        parallel.make_mesh / data_parallel_mesh / Communicator, and
        opt.DistOpt's four strategies in Model's graph-mode step

The attention paths run on six hand-written CUDA kernels in `csrc/`
(flash-attention forward, its fused and split backward, flash-decode and
paged decode attention over fp, int8 and int4 caches with the
speculative verify ladder), bound in `ops.attention`; convolutions,
normalizations, pooling and matmuls are torch ops. Entry points run on
CUDA unless the caller passes `device="cpu"` (or a CPU `Device`), where
every kernel wrapper runs its plain PyTorch version instead.
"""

from . import (autograd, data, device, distributed, io, layer,  # noqa: F401
               model, models, native, opt, overlap, parallel, snapshot,
               sonnx, tensor, utils)

__all__ = ["autograd", "data", "device", "distributed", "io", "layer",
           "model", "models", "native", "opt", "overlap", "parallel",
           "snapshot", "sonnx", "tensor", "utils"]

#: the operations modules, imported at first attribute access as the JAX
#: package's are (`singa_tpu_torch.fleet`)
_LAZY_MODULES = ("observe", "health", "serving", "introspect", "goodput",
                 "diag", "resilience", "fleet", "memory", "watchdog",
                 "engine")


def __getattr__(name):
    if name in _LAZY_MODULES:
        import importlib
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(
        f"module 'singa_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY_MODULES))
