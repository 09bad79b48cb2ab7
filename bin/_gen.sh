#!/bin/sh
# regenerate the host-tool launchers (run from repo root: sh bin/_gen.sh)
set -e
cd "$(dirname "$0")"
for t in histex tabex profex fastrm fastmv fastcp logex symmex \
         fastmerge fastcat vennex haplex homex; do
  cat > "$t" <<SCRIPT
#!/bin/sh
# $t — host-only CLI launcher (no accelerator).
#
# These tools are pure host code (the reference's are standalone C
# binaries): JAX is held to the CPU so a tool never initialises a device.
# FASTK_PYTHON overrides the interpreter.
d=\$(CDPATH= cd -- "\$(dirname -- "\$0")/.." && pwd)
JAX_PLATFORMS=cpu PYTHONPATH="\$d\${PYTHONPATH:+:\$PYTHONPATH}" \\
  exec "\${FASTK_PYTHON:-python3}" -m fastk_tpu.tools.$t "\$@"
SCRIPT
  chmod +x "$t"
done
# device-path tools keep the environment intact (they count on the GPU)
for t in fastk kmermap; do
  cat > "$t" <<SCRIPT
#!/bin/sh
# $t — device-path CLI launcher (counts on the GPU; environment kept).
d=\$(CDPATH= cd -- "\$(dirname -- "\$0")/.." && pwd)
PYTHONPATH="\$d\${PYTHONPATH:+:\$PYTHONPATH}" \\
  exec "\${FASTK_PYTHON:-python3}" -m fastk_tpu.tools.$t "\$@"
SCRIPT
  chmod +x "$t"
done
