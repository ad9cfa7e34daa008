"""The interactive viewer of the port: ``ViewerApp`` (the per-frame
train / render loop and every viewer action) and ``serve`` (an HTTP
server streaming MJPEG and taking JSON control)."""

from .app import ViewerApp
from .camera import OrbitCamera
from .controllers import FrameTimer, ResolutionController, TrainStepController
from .server import serve

__all__ = ["FrameTimer", "OrbitCamera", "ResolutionController",
           "TrainStepController", "ViewerApp", "serve"]
