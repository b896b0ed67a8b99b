# coding=utf-8
"""Multi-device execution: element sharding over ``torch.distributed``
ranks (``sharding.py``) and a launcher of CPU ranks (``launch.py``)."""
