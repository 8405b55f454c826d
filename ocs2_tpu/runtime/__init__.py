"""Native real-time runtime: policy transport, rate loops, serialization.

The host-side runtime around the device solve — the analogue of the reference's
ocs2_ros_interfaces + thread_support stack, implemented in C++
(native/ocs2rt.cpp) with ctypes bindings (runtime/native.py).
"""
