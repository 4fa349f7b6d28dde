from hgaprec_tpu_torch.data.ratings import RatingsStore, CountMap
from hgaprec_tpu_torch.data.device import DeviceData, build_device_data

__all__ = ["RatingsStore", "CountMap", "DeviceData", "build_device_data"]
