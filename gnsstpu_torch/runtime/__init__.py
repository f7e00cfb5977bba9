"""Runtime of the port: sample sources and the live ChannelManager. The
online navigator and telemetry bus have no JAX in them and are the
reference's own, re-exported here."""

from gnsstpu.runtime.navigator import OnlineNavigator  # noqa: F401
from gnsstpu.runtime.telemetry import Telemetry  # noqa: F401
