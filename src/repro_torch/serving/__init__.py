from .device_state import DeviceState
from .engine import ServingEngine
from .scheduler import Request, Scheduler

__all__ = ["ServingEngine", "Request", "Scheduler", "DeviceState"]
