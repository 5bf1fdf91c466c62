"""The benchmark's plain reference: a straightforward PyTorch / NumPy pose
refiner with the semantics of meiqua/pose_refine (render -> window lift ->
projective or nearest-neighbour association -> damped point-to-plane ICP)
and of the tracking session's filter.

It imports nothing of the program under test. Where the semantics are the
program's own (the window lift's selection, the LINEMOD normals, the ROI
planning, the mesh decimation, the filter), the code is a frozen copy
written out here, so a later change to the program cannot move the
yardstick. Everything is float32 with TF32 off unless a function says
otherwise; ``tf32()`` switches matrix products to TF32, the precision the
benchmark's control runs in.
"""
