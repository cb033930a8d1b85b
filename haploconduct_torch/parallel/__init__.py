"""Work over several devices (mesh.py) and several processes
(distributed.py), and the choice of device (devices.py)."""
