"""Multi-device execution: a dp x rp mesh of torch devices
(``mesh.py``) and multi-process host staging feeding one device
(``hostshard.py``)."""
