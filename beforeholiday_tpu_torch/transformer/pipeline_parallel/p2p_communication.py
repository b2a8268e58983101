"""Pipeline stage communication — counterpart of
``beforeholiday_tpu/transformer/pipeline_parallel/p2p_communication.py``
(ref: apex/transformer/pipeline_parallel/p2p_communication.py:48-578).

Every pattern is a ring shift over the pipe group through
``monitor.comms.ppermute`` (one ``batch_isend_irecv`` of the neighbours'
send and receive): activations ride the +1 ring (site ``pp.fwd_ring``),
gradients the -1 ring (``pp.bwd_ring``). As in JAX, the first stage receives
the last stage's value from the forward ring, and the callers ignore it.
"""

from __future__ import annotations

from beforeholiday_tpu_torch.monitor import comms
from beforeholiday_tpu_torch.parallel.bucketing import static_axis_size
from beforeholiday_tpu_torch.parallel.parallel_state import PIPE_AXIS

__all__ = [
    "recv_backward", "recv_forward", "send_backward", "send_backward_recv_backward",
    "send_backward_recv_forward", "send_forward", "send_forward_recv_backward",
    "send_forward_recv_backward_double_buffered", "send_forward_recv_forward",
]


def _ring(axis_name: str, shift: int):
    n = static_axis_size(axis_name)
    return [(i, (i + shift) % n) for i in range(n)]


def send_forward_recv_forward(x, *, axis_name: str = PIPE_AXIS):
    """Every stage sends its activation to the next stage and receives the
    previous stage's (ref: send_forward + recv_forward fused)."""
    return comms.ppermute(x, axis_name, _ring(axis_name, +1), site="pp.fwd_ring")


def send_backward_recv_backward(dy, *, axis_name: str = PIPE_AXIS):
    """The gradient ring, in the reverse direction."""
    return comms.ppermute(dy, axis_name, _ring(axis_name, -1), site="pp.bwd_ring")


# the reference's public names: on a ring the send and receive halves are one
# exchange, so each maps to it
send_forward = send_forward_recv_forward
recv_forward = send_forward_recv_forward
send_backward = send_backward_recv_backward
recv_backward = send_backward_recv_backward


def send_forward_recv_backward(y, dy, *, axis_name: str = PIPE_AXIS):
    """The steady-state 1F1B pair: the activation ring forward and the
    gradient ring backward, one tick."""
    return (send_forward_recv_forward(y, axis_name=axis_name),
            send_backward_recv_backward(dy, axis_name=axis_name))


def send_backward_recv_forward(dy, y, *, axis_name: str = PIPE_AXIS):
    out_y, out_dy = send_forward_recv_backward(y, dy, axis_name=axis_name)
    return out_dy, out_y


def send_forward_recv_backward_double_buffered(pending_y, pending_dy, *,
                                               axis_name: str = PIPE_AXIS):
    """The 1F1B pair on the previous tick's outputs (the double-buffered
    exchange of the overlap schedules): the same exchange and sites."""
    return send_forward_recv_backward(pending_y, pending_dy, axis_name=axis_name)
