"""The headline benchmark on the card: its workload (``workload.py``), the
timing protocols (``timing.py``), the work it must do (``roofline.py``), the
serial NumPy oracle (``cpu_reference.py``) and the measurement with its CPU
baseline (``headline.py``, ``python -m roborts_slam_tpu_torch bench``)."""
