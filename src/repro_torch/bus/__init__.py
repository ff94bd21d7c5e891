"""I/O middleware models: pub/sub broker + transport cost models, and the
simulated clock the batched engine, the serving runtime and the
observability layer share (pure Python and NumPy, copied from the
reference's ``repro.bus``)."""
from .clock import SimClock
from .pubsub import Broker, Envelope, Subscription
from .transport import CopyTransport, DatagramTransport, Message, publish_latencies

__all__ = [
    "CopyTransport", "DatagramTransport", "Message", "publish_latencies",
    "Broker", "Envelope", "Subscription", "SimClock",
]
