"""IF-signal simulation of the port: the torch IFSimulator and the GPS
scenario builder, so a GPU host without JAX can make its own signal."""

from gnsstpu_torch.sim.generator import IFSimulator, SatParams  # noqa: F401
