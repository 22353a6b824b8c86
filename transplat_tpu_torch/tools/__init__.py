"""The reference's visual tools on the port's modules, each run as
`python -m transplat_tpu_torch.tools.<name>` (on the card unless
`--device cpu`):

  * test_splatter             a camera spinning around random Gaussians
                              (render, SH rotation): PNG frames and an mp4
  * visualize_epipolar_lines  the plane-sweep samples of view A's query
                              pixels drawn in view B, for chunk scenes
"""
