"""GPS L1 C/A for the test configurations beside this folder: the
harness's own signal module (portbench/signals/gps_l1ca.py), so that a
run with these data as its base makes the cells' skies."""

from portbench import plan

_GPS = plan.signal("gps_l1ca")
code, sky, broadcast = _GPS.code, _GPS.sky, _GPS.broadcast
