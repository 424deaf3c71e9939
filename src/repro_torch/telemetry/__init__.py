"""Telemetry: communication census, staleness/participation metrics,
per-client DP accounting, JSONL traces, the in-loop op census, and
span-based profiling with Perfetto timeline export — the reference's
``MetricsReport`` schema, shared by all three engines."""
from repro_torch.telemetry.costs import (
    N_OPS, OP_NAMES, check_ops, cost_decomposition, ops_dict, ops_vector,
    zero_ops,
)
from repro_torch.telemetry.report import (
    HEADER_BYTES, STALE_BINS, MetricsReport, broadcast_msg_bytes,
    build_report, model_flat_dim, participation_sizes, staleness_bin,
    update_msg_bytes,
)
from repro_torch.telemetry.spans import (
    SpanRecorder, device_events, maybe_span, trace_to_perfetto,
    validate_trace_events, write_perfetto,
)
from repro_torch.telemetry.trace import JsonlTraceWriter, open_trace

__all__ = [
    "HEADER_BYTES", "STALE_BINS", "MetricsReport", "broadcast_msg_bytes",
    "build_report", "model_flat_dim", "participation_sizes",
    "staleness_bin", "update_msg_bytes",
    "JsonlTraceWriter", "open_trace",
    "SpanRecorder", "device_events", "maybe_span", "trace_to_perfetto",
    "validate_trace_events", "write_perfetto",
    "N_OPS", "OP_NAMES", "check_ops", "cost_decomposition", "ops_dict",
    "ops_vector", "zero_ops",
]
