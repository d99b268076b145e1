"""Device resolution for the port."""

from .device import DeviceUnavailableError, card_info, resolve_device  # noqa: F401
