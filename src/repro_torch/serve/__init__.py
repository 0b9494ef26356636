"""Online serving layer: the continuous-batching LM engine (``engine``) and
the online admission engine (``admission``)."""
from .admission import (Arrival, ExternalEvents, OnlineAdmissionEngine,
                        OperatingPoint, default_policy_param,
                        format_operating_derived, load_operating_point,
                        operating_row_name, window_seed)
from .engine import Request, ServeEngine

__all__ = ["Arrival", "ExternalEvents", "OnlineAdmissionEngine",
           "OperatingPoint", "Request", "ServeEngine", "default_policy_param",
           "format_operating_derived", "load_operating_point",
           "operating_row_name", "window_seed"]
