"""The four walkthroughs of the repository's examples/ folder, on the port.

Each module takes the same steps at the same sizes as its JAX twin in
examples/, prints the same labelled lines, keeps the twin's asserts and
returns a dict of the figures it prints:

    python -m medicalimageanalysis_torch.examples.end_to_end
    python -m medicalimageanalysis_torch.examples.registration_suite
    python -m medicalimageanalysis_torch.examples.adaptive_rt
    python -m medicalimageanalysis_torch.examples.cohort_scale

Each runs on the card unless ``--device cpu`` (or ``main(device="cpu")``)
asks for the CPU; ``--workdir`` (``workdir=``) names the folder it
writes its DICOM series into, else a new temporary one.
"""
