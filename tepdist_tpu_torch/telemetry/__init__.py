"""Unified telemetry: span tracing, metrics registry, Perfetto export.

Usage::

    from tepdist_tpu_torch.telemetry import span, metrics

    with span("compute:fwd", cat="compute", stage=0) as sp:
        ...work...
        sp.set(bytes=n)
    metrics().counter("steps").inc()

Spans are gated by ``TEPDIST_TRACE`` (or ``DEBUG``) and cost one branch
when disabled; metrics are always on.

The port's copy of the JAX package's ``telemetry/``: the code is
framework-neutral, so it is the same module for module, with imports that
stay inside ``tepdist_tpu_torch``. Its native rings build from this
package's own ``_fastobs.c`` into ``tepdist_tpu_torch/_build/`` under the
module name ``_tepdist_torch_fastobs``. Keep the two copies in step.
"""

from tepdist_tpu_torch.telemetry.metrics import (  # noqa: F401
    MetricsRegistry,
    metrics,
)
from tepdist_tpu_torch.telemetry.trace import (  # noqa: F401
    _NULL_SPAN,
    Span,
    Tracer,
    configure,
    enabled,
    span,
    tracer,
)
from tepdist_tpu_torch.telemetry.export import (  # noqa: F401
    CLIENT_PID,
    build_trace,
    dump_merged_trace,
    to_chrome_events,
    to_prometheus,
    write_trace,
)
from tepdist_tpu_torch.telemetry import calibrate  # noqa: F401
from tepdist_tpu_torch.telemetry import fidelity  # noqa: F401
from tepdist_tpu_torch.telemetry import flight  # noqa: F401
from tepdist_tpu_torch.telemetry import ledger  # noqa: F401
from tepdist_tpu_torch.telemetry import observatory  # noqa: F401
from tepdist_tpu_torch.telemetry.watchtower import (  # noqa: F401
    HealthAlert,
    TrainingSentinel,
    WatchHalt,
    Watchtower,
    active_alerts,
)
