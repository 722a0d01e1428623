#version 330 core
uniform sampler2D color_tex;
in vec2 v_uv;
in float v_valid;
out vec4 frag_color;
void main() {
  if (v_valid < 0.5) discard;
  frag_color = vec4(texture(color_tex, v_uv).rgb, 1.0);
}
