"""Viewer package (counterpart of ``nerfstudio_tpu/viewer/``): a standard
library websocket and HTTP server (``server.Viewer``), the browser client
(``client.html``), the panels and the user-API widgets (reference
nerfstudio/viewer/)."""

from nerfstudio_torch.viewer.viewer_elements import (  # noqa: F401
    ViewerButton,
    ViewerButtonGroup,
    ViewerCheckbox,
    ViewerClick,
    ViewerControl,
    ViewerDropdown,
    ViewerElement,
    ViewerNumber,
    ViewerParameter,
    ViewerRGB,
    ViewerSlider,
    ViewerText,
    ViewerVec3,
    collect_viewer_elements,
)
