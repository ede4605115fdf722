from .gui_utils import GaussianPacket, Packet_vis2main, ParamsGUI  # noqa: F401
