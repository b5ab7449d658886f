"""Matplotlib's 'plasma' colour map as OpenCV applies it
(``cv2.applyColorMap(x, cv2.COLORMAP_PLASMA)``): the port's own
256-entry table, so the viewer colours depth without OpenCV.

``PLASMA_RGB[v]`` is the RGB colour of 8-bit value ``v``;
``tests/test_torch_viz.py`` holds it against cv2's table.
"""

from __future__ import annotations

import numpy as np

PLASMA_RGB = np.frombuffer(bytes.fromhex(
    "0d088710078813078916078a19068c1b068d1d068e20068f220690240691260591280592"
    "2a05932c05942e05952f059631059733059735049837049938049a3a049a3c049b3e049c"
    "3f049c41049d43039e44039e46039f48039f4903a04b03a14c02a14e02a25002a25102a3"
    "5302a35502a45601a45801a45901a55b01a55c01a65e01a66001a66100a76300a76400a7"
    "6600a76700a86900a86a00a86c00a86e00a86f00a87100a87201a87401a87501a87701a8"
    "7801a87a02a87b02a87d03a87e03a88004a88104a78305a78405a78606a68707a68808a6"
    "8a09a58b0aa58d0ba58e0ca48f0da4910ea3920fa39410a29511a19613a19814a099159f"
    "9a169f9c179e9d189d9e199da01a9ca11b9ba21d9aa31e9aa51f99a62098a72197a82296"
    "aa2395ab2494ac2694ad2793ae2892b02991b12a90b22b8fb32c8eb42e8db52f8cb6308b"
    "b7318ab83289ba3388bb3488bc3587bd3786be3885bf3984c03a83c13b82c23c81c33d80"
    "c43e7fc5407ec6417dc7427cc8437bc9447aca457acb4679cc4778cc4977cd4a76ce4b75"
    "cf4c74d04d73d14e72d24f71d35171d45270d5536fd5546ed6556dd7566cd8576bd9586a"
    "da5a6ada5b69db5c68dc5d67dd5e66de5f65de6164df6263e06363e16462e26561e26660"
    "e3685fe4695ee56a5de56b5de66c5ce76e5be76f5ae87059e97158e97257ea7457eb7556"
    "eb7655ec7754ed7953ed7a52ee7b51ef7c51ef7e50f07f4ff0804ef1814df1834cf2844b"
    "f3854bf3874af48849f48948f58b47f58c46f68d45f68f44f79044f79143f79342f89441"
    "f89540f9973ff9983ef99a3efa9b3dfa9c3cfa9e3bfb9f3afba139fba238fca338fca537"
    "fca636fca835fca934fdab33fdac33fdae32fdaf31fdb130fdb22ffdb42ffdb52efeb72d"
    "feb82cfeba2cfebb2bfebd2afebe2afec029fdc229fdc328fdc527fdc627fdc827fdca26"
    "fdcb26fccd25fcce25fcd025fcd225fbd324fbd524fbd724fad824fada24f9dc24f9dd25"
    "f8df25f8e125f7e225f7e425f6e626f6e826f5e926f5eb27f4ed27f3ee27f3f027f2f227"
    "f1f426f1f525f0f724f0f921"
), np.uint8).reshape(256, 3)


def apply_plasma(u8: np.ndarray) -> np.ndarray:
    """(H, W) uint8 -> (H, W, 3) uint8 RGB through the plasma table."""
    return PLASMA_RGB[np.asarray(u8, np.uint8)]
