"""Runtime of the port: sample sources and the live ChannelManager, and
the online navigator and telemetry bus (the port's copies of the
reference's modules), re-exported here."""

from gnsstpu_torch.runtime.navigator import OnlineNavigator  # noqa: F401
from gnsstpu_torch.runtime.telemetry import Telemetry  # noqa: F401
