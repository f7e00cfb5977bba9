"""Tracking of the port: the exact scan tracker (oracle), the fused K1
tracker, lock detection, the per-family engine adapters of the live
ChannelManager, the offline chunked drivers (driver.track with
ChannelInit / TrackResults, boc.track_boc, dual.track_dual; the chain
that runtime.receiver.run_receiver and the CLI's `solve` run, whose
telemetry log the CLI's `analyze` renders) and the GLONASS P-code
tracker (pcode). Submodules are imported where used, so importing one
pulls in no other: callers import from tracking.driver. The sharded
trackers (one per shard of a device mesh) are in parallel.fused_shard."""
