"""HTTP client for the Black Forest Labs image-generation API.

Counterpart of the JAX package's `api.py`: submit a generation request to
api.bfl.ml, poll until it is ready, fetch or save the result. The network is
used only when a request is launched or read, `requests` is imported only
then, and an error status raises `ApiException`.
"""

from __future__ import annotations

import io
import os
import time
from typing import Optional

API_URL = "https://api.bfl.ml"
API_ENDPOINTS = {
    "flux.1-pro": "flux-pro",
    "flux.1-dev": "flux-dev",
    "flux.1.1-pro": "flux-pro-1.1",
}


class ApiException(Exception):
    def __init__(self, status_code: int, detail: Optional[str] = None):
        super().__init__(f"api returned {status_code}: {detail}")
        self.status_code = status_code
        self.detail = detail


class ImageRequest:
    """Submit and poll one generation request.

    request = ImageRequest(prompt="a dragon", name="flux.1-dev")
    request.save("out.png")
    """

    def __init__(
        self,
        prompt: str,
        name: str = "flux.1.1-pro",
        width: int = 1024,
        height: int = 1024,
        steps: Optional[int] = None,
        guidance: Optional[float] = None,
        seed: Optional[int] = None,
        prompt_upsampling: bool = False,
        safety_tolerance: int = 6,
        api_key: Optional[str] = None,
        launch: bool = True,
    ):
        if name not in API_ENDPOINTS:
            raise ValueError(f"unknown model {name}; options: {list(API_ENDPOINTS)}")
        if width % 32 or height % 32:
            raise ValueError("dimensions must be multiples of 32")
        self.request_json = {
            "prompt": prompt,
            "width": width,
            "height": height,
            "steps": steps,
            "guidance": guidance,
            "seed": seed,
            "prompt_upsampling": prompt_upsampling,
            "safety_tolerance": safety_tolerance,
        }
        self.request_json = {k: v for k, v in self.request_json.items() if v is not None}
        self.name = name
        self.request_id: Optional[str] = None
        self.result: Optional[dict] = None
        self._image_bytes: Optional[bytes] = None
        self.api_key = api_key or os.environ.get("BFL_API_KEY")
        if launch:
            self.request()

    def request(self) -> None:
        import requests

        resp = requests.post(
            f"{API_URL}/v1/{API_ENDPOINTS[self.name]}",
            headers={"accept": "application/json", "x-key": self.api_key,
                     "Content-Type": "application/json"},
            json=self.request_json,
        )
        result = resp.json()
        if resp.status_code != 200:
            raise ApiException(resp.status_code, result.get("detail"))
        self.request_id = result["id"]

    def retrieve(self) -> dict:
        import requests

        if self.request_id is None:
            self.request()
        while self.result is None:
            resp = requests.get(
                f"{API_URL}/v1/get_result",
                headers={"accept": "application/json", "x-key": self.api_key},
                params={"id": self.request_id},
            )
            result = resp.json()
            if "status" not in result:
                raise ApiException(resp.status_code, result.get("detail"))
            if result["status"] == "Ready":
                self.result = result["result"]
            elif result["status"] == "Pending":
                time.sleep(0.5)
            else:
                raise ApiException(200, f"generation failed: {result['status']}")
        return self.result

    @property
    def bytes(self) -> bytes:
        import requests

        if self._image_bytes is None:
            result = self.retrieve()
            resp = requests.get(result["sample"])
            if resp.status_code != 200:
                raise ApiException(resp.status_code)
            self._image_bytes = resp.content
        return self._image_bytes

    @property
    def image(self):
        import PIL.Image

        return PIL.Image.open(io.BytesIO(self.bytes))

    def save(self, path: str) -> None:
        suffix = os.path.splitext(self.retrieve()["sample"])[1].split("?")[0]
        if not os.path.splitext(path)[1]:
            path = path + suffix
        with open(path, "wb") as f:
            f.write(self.bytes)
